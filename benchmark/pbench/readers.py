"""Arithmetic the per-layer metrics' readers share (benchmark/metrics/)."""

from __future__ import annotations

# the program's top-level stages of one ris job; their sub-stages
# (ris.fused.*, ris.gapped.*) run inside them
RIS_STAGES = ("ris.accessibility", "ris.seed", "ris.fused", "ris.mid",
              "ris.gapped", "ris.finish", "ris.format")
DB_STAGES = ("db.accessibility", "db.index")


def per_mnt(run, seconds):
    """Seconds per million nucleotides of the window's work; None where
    the window did none."""
    if run.work_nt <= 0:
        return None
    return seconds / (run.work_nt / 1e6)


def span_per_mnt(run, *names):
    """The summed time of the named program stages in the window, per
    million nucleotides; None where none of them ran."""
    if not any(n in run.spans for n in names):
        return None
    return per_mnt(run, sum(run.spans.get(n, 0.0) for n in names))


def outside_spans_per_mnt(run, names):
    """The window's time outside the named top-level stages, per million
    nucleotides (below zero where stages ran side by side)."""
    return per_mnt(run, run.window_s - sum(run.spans.get(n, 0.0)
                                           for n in names))


def idle_share(run):
    """The share of the traced window, in %, in which no kernel, copy or
    memset ran on the card; None without a trace."""
    t = run.devtrace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
