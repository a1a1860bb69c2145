"""ris_kernel_s_per_qmnt: the card's kernel time in the window of the ris
cells, in seconds per million query nucleotides: every kernel interval of
the window's device trace (the search's and the accessibility's kernels,
and PyTorch's own), summed, over the query nucleotides of the window's
jobs. Memory copies and memsets are not counted (they are in
device_idle_share.ris and the breakdown). None without a trace or where
no kernel ran."""

from pbench import readers


def read(run):
    t = run.devtrace
    if t is None or not t.kernels:
        return None
    return readers.per_mnt(run, sum(s for _, s in t.kernels))
