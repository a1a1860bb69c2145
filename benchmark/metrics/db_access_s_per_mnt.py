"""db_access_s_per_mnt: the program's `db.accessibility` stage, in seconds
per million target nucleotides."""

from pbench import readers


def read(run):
    return readers.span_per_mnt(run, "db.accessibility")
