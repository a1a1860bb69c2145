"""The traced run's device trace: torch.profiler around the measured
window, read back from its Chrome trace.

- busy: the union of the intervals of kernels, memory copies and memsets
  on the card, inside the window;
- the window: the `bench.window` range the harness opens around the jobs;
- device_ops: device time by operation name;
- idle gaps: the stretches of the window with no device interval, each
  named by the host event (a program stage, a PyTorch op, a CUDA runtime
  call) that covers most of it, with the share it covers;
- kernels: every kernel interval, (name, seconds), for the rooflines'
  readers.

In a traced run each stage of the program (`utils.profiling.stage`)
also opens a profiler range of its name, so gaps can be named by stage."""

from __future__ import annotations

import contextlib
import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


@contextlib.contextmanager
def stage_ranges():
    """While open, every program stage is also a profiler range."""
    import torch
    from priblast_tpu_torch.utils import profiling

    orig = profiling.stage

    @contextlib.contextmanager
    def stage(name, devices=None):
        with torch.profiler.record_function(name):
            with orig(name, devices):
                yield

    profiling.stage = stage
    try:
        yield
    finally:
        profiling.stage = orig


@contextlib.contextmanager
def profiled(out: Path):
    """torch.profiler over the block; the Chrome trace goes to `out`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with stage_ranges():
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                yield
    prof.export_chrome_trace(str(out))


def _union(iv):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """The parsed trace. Times in seconds."""

    def __init__(self, path: Path):
        events = json.loads(Path(path).read_text())["traceEvents"]
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no window range")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) / 1e6
        dev, host, kernels = [], [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            s = float(e["ts"])
            t = s + float(e["dur"])
            s, t = max(s, w0), min(t, w1)
            if t <= s:
                continue
            if cat in DEVICE_CATS:
                dev.append((s, t, e.get("name", ""), cat))
                if cat == "kernel":
                    kernels.append((e.get("name", ""), (t - s) / 1e6))
            elif cat in HOST_CATS and e.get("name") != WINDOW:
                host.append((s, t, e.get("name", "")))
        self.kernels = kernels
        busy = _union([(s, t) for s, t, _, _ in dev])
        self.busy_s = sum(t - s for s, t in busy) / 1e6
        by_name: dict[str, float] = {}
        for s, t, name, _ in dev:
            by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])
        gaps, prev = [], w0
        for s, t in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        if w1 > prev:
            gaps.append((prev, w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        host.sort()
        self.idle_gaps = [(self._label(g, host), (g[1] - g[0]) / 1e6)
                          for g in gaps[:10]]

    @staticmethod
    def _label(gap, host):
        """The host event that covers most of the gap (of two alike, the
        shorter, the inner one), with the share of the gap it covers."""
        g0, g1 = gap
        best, key = None, None
        for s, t, name in host:
            if s >= g1:
                break
            ov = min(t, g1) - max(s, g0)
            if ov <= 0:
                continue
            k = (ov, -(t - s))
            if key is None or k > key:
                best, key = name, k
        if best is None:
            return "no host event recorded"
        return f"{best} ({100.0 * key[0] / (g1 - g0):.0f}% of the gap)"

    def breakdown(self) -> dict:
        return {"device_ops": [[n, s] for n, s in self.device_ops[:10]],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps]}
