"""ris_dbpack_bytes_per_nt: the bytes the database's pack places on the
card per target nucleotide loaded (counters `ris.dbpack.bytes`, summed
over the distinct cards, over `ris.db_nt`)."""

from pbench import program


def read(run):
    return program.ratio("ris.dbpack.bytes", "ris.db_nt")
