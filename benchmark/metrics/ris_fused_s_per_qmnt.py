"""ris_fused_s_per_qmnt: the program's `ris.fused` stage, the fused stage
(pack, expansion, ungapped kernel, threshold, records), in seconds per
million query nucleotides."""

from pbench import readers


def read(run):
    return readers.span_per_mnt(run, "ris.fused")
