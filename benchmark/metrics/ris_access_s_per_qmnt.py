"""ris_access_s_per_qmnt: the program's `ris.accessibility` stage, the
query accessibility, in seconds per million query nucleotides."""

from pbench import readers


def read(run):
    return readers.span_per_mnt(run, "ris.accessibility")
