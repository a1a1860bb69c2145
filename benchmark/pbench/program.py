"""What the program's own tracing holds beyond `run.spans`, for the
per-layer readers (benchmark/metrics/): its counters
(`priblast_tpu_torch.utils.profiling.counters()`, cleared with the spans
by the `reset()` at the window's start; the check after the window runs
no program code) and the host pools' busy shares. Where the program keeps
no counters, or a counter did not run, the readers find nothing."""

from __future__ import annotations


def counters() -> dict:
    """The program's counters over the window; {} where it keeps none:
    this benchmark's traced runs also run over checkouts of the port from
    before `profiling.counters()` existed, and a reader must not raise
    there."""
    from priblast_tpu_torch.utils import profiling

    read = getattr(profiling, "counters", None)
    return read() if read is not None else {}


def ratio(num: str, den: str, scale: float = 1.0):
    """scale x counter `num` / counter `den`; None where `den` did not
    count."""
    c = counters()
    if c.get(den, 0) <= 0:
        return None
    return scale * c.get(num, 0) / c[den]


def pool_share(run, stage: str):
    """The busy share, in %, of a host pool the program maps a stage's
    groups over: the groups' summed span (`<stage>.group`) over the maps'
    wall time times the threads each could keep busy (the counter
    `<stage>.pool_s`); None where the stage did not map."""
    pool_s = counters().get(f"{stage}.pool_s", 0)
    busy = run.spans.get(f"{stage}.group")
    if pool_s <= 0 or busy is None:
        return None
    return 100.0 * busy / pool_s
