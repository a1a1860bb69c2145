"""Stage timing and profiling hooks.

Every pipeline stage can be timed with ``stage(name, devices)``; a summary
is printed when PRIBLAST_TIMINGS=1. On CUDA devices the stage
synchronises the current stream of every card of the list before reading
the clock on each side, so the time covers the device work the stage
queued on all of its shards and not only its launches; work on other
streams (the fused stage's record copies) runs on.
``device_trace(name)`` wraps a block in a ``torch.profiler`` trace
(exported as a Chrome trace) when PRIBLAST_TRACE_DIR is set.

Stages may run on several threads at once (the ris router's hybrid split
runs the host and device chains side by side, and each shard of a split
device stage runs on a thread of its own): the sums are kept under a
lock, and then the stage seconds of the threads overlap, so they do not
add up to the wall time.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

_times: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
_lock = threading.Lock()


def enabled() -> bool:
    return os.environ.get("PRIBLAST_TIMINGS", "") not in ("", "0")


def _sync(devices) -> None:
    """Wait for the current stream of every card of `devices` (one device
    or a list; None for none)."""
    if devices is None:
        return
    import torch

    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    for dev in dict.fromkeys(torch.device(d) for d in devices):
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()


@contextlib.contextmanager
def stage(name: str, devices=None):
    """Time the block as stage `name`; on the cards of `devices` (one
    device or a list) the clock is read after each of their current
    streams has finished its queued work, so a split stage covers all of
    its shards."""
    _sync(devices)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(devices)
        dt = time.perf_counter() - t0
        with _lock:
            _times[name] += dt
            _counts[name] += 1


@contextlib.contextmanager
def device_trace(name: str):
    trace_dir = os.environ.get("PRIBLAST_TRACE_DIR", "")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))


def snapshot() -> dict[str, float]:
    with _lock:
        return dict(_times)


def counts() -> dict[str, int]:
    with _lock:
        return dict(_counts)


def reset() -> None:
    with _lock:
        _times.clear()
        _counts.clear()


def report() -> str:
    lines = ["stage timings:"]
    with _lock:
        rows = sorted(_times.items(), key=lambda kv: -kv[1])
        for name, total in rows:
            lines.append(f"  {name:32s} {total:9.3f}s  x{_counts[name]}")
    return "\n".join(lines)


def maybe_report() -> None:
    if enabled() and _times:
        print(report())
