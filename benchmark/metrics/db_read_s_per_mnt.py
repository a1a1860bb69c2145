"""db_read_s_per_mnt: the program's `db.read` span, the FASTA read of each
build, in seconds per million target nucleotides."""

from pbench import readers


def read(run):
    return readers.span_per_mnt(run, "db.read")
