"""ris_seed_s_per_qmnt: the program's `ris.seed` stage, the host seed DFS,
in seconds per million query nucleotides."""

from pbench import readers


def read(run):
    return readers.span_per_mnt(run, "ris.seed")
