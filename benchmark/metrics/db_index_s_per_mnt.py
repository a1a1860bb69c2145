"""db_index_s_per_mnt: the program's `db.index` stage (encoding, suffix
array, k-mer hash, the .ind and .seq writes), in seconds per million
target nucleotides."""

from pbench import readers


def read(run):
    return readers.span_per_mnt(run, "db.index")
