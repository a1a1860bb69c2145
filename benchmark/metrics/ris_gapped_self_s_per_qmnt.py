"""ris_gapped_self_s_per_qmnt: the gapped stage's own host time, the
`ris.gapped` span less its `ris.gapped.fetch` (the wait on the kernels
and their copies) and `ris.gapped.rerun_wait` (the wait on the overflow
pool) spans: the hit columns' uploads, the launches, the traceback's
numpy work and the patch, in seconds per million query nucleotides."""

from pbench import readers


def read(run):
    s = run.spans
    if "ris.gapped" not in s or "ris.gapped.fetch" not in s:
        return None
    return readers.per_mnt(run, s["ris.gapped"] - s["ris.gapped.fetch"]
                           - s.get("ris.gapped.rerun_wait", 0.0))
