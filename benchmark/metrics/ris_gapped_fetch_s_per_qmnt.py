"""ris_gapped_fetch_s_per_qmnt: the program's `ris.gapped.fetch` span, the
host waiting on the gapped kernels of both directions and on their
results' copy to pageable host memory, in seconds per million query
nucleotides."""

from pbench import readers


def read(run):
    return readers.span_per_mnt(run, "ris.gapped.fetch")
