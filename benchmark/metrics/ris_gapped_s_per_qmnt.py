"""ris_gapped_s_per_qmnt: the program's `ris.gapped` stage, the gapped
extension and its overflow fallback, in seconds per million query
nucleotides."""

from pbench import readers


def read(run):
    return readers.span_per_mnt(run, "ris.gapped")
