"""ris_finish_s_per_qmnt: the program's `ris.finish` and `ris.format`
stages, the host finish and the output lines, in seconds per million
query nucleotides."""

from pbench import readers


def read(run):
    return readers.span_per_mnt(run, "ris.finish", "ris.format")
