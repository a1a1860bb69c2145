"""ris_mid_s_per_qmnt: the program's `ris.mid` stage, the host mid stage,
in seconds per million query nucleotides."""

from pbench import readers


def read(run):
    return readers.span_per_mnt(run, "ris.mid")
