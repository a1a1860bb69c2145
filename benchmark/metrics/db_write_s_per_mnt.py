"""db_write_s_per_mnt: the program's `db.write` span, the .acc, .nam and
.bas writes of each build, in seconds per million target nucleotides."""

from pbench import readers


def read(run):
    return readers.span_per_mnt(run, "db.write")
