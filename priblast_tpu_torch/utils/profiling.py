"""Stage spans, counters and traces: the port's one tracing module.

Every pipeline stage can be timed with ``stage(name, devices)``; a summary
is printed when PRIBLAST_TIMINGS=1. On CUDA devices the stage
synchronises the current stream of every card of the list before reading
the clock on each side, so the time covers the device work the stage
queued on all of its shards and not only its launches; work on other
streams (the fused stage's record copies) runs on.

Each call adds to its stage's sum (``snapshot``, ``counts``) and records
an interval (``intervals``): the name, the thread, the enclosing stage on
the same thread, the command's run id (one per ``command``: a db or ris
run) and its start and end, in a bounded buffer that drops its oldest
entries when full (counted as ``profiling.dropped``). Where a profiler
records on the calling thread (torch.profiler only sees the thread that
started it), the stage is also a ``record_function`` range of its name,
so any trace carries the stages on the device trace's clock.

``count(name, n)`` adds to a counter: host arithmetic on values the code
already holds, never a read of the device.

``command(kind)`` wraps one db or ris command. When PRIBLAST_TRACE_DIR is
set and no profiler records already, it writes one Chrome trace of the
command there, with the stages of the threads the profiler did not see
(the host pools) added as events of their own threads.

Stages may run on several threads at once (the ris router's hybrid split
runs the host and device chains side by side, and each shard of a split
device stage runs on a thread of its own): the sums are kept under a
lock, and then the stage seconds of the threads overlap, so they do not
add up to the wall time.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple

import torch

_times: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
_counters: dict[str, float] = defaultdict(int)
# (name, thread, parent, run, start, end), start and end on perf_counter_ns
_intervals: deque = deque(maxlen=1 << 16)
_lock = threading.Lock()
_local = threading.local()   # .stack: the thread's open stages; .tid
_run = 0                     # the run id of the command in progress
_runs = 0                    # run ids handed out
# (time_ns, perf_counter_ns) read together: places perf_counter_ns on the
# realtime clock that torch.profiler's Chrome traces use
_anchor = (time.time_ns(), time.perf_counter_ns())


class Interval(NamedTuple):
    """One stage call. `start` and `end` are nanoseconds on the realtime
    clock (time.time_ns), the clock of torch.profiler's Chrome traces
    (their `ts` in µs plus `baseTimeNanoseconds`)."""
    name: str
    thread: int          # threading.get_native_id(), a trace's `tid`
    parent: str | None   # the enclosing stage on the same thread
    run: int             # the command's run id; 0 outside any command
    start: int
    end: int


def enabled() -> bool:
    return os.environ.get("PRIBLAST_TIMINGS", "") not in ("", "0")


def _sync(devices) -> None:
    """Wait for the current stream of every card of `devices` (one device
    or a list; None for none)."""
    if devices is None:
        return
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    for dev in dict.fromkeys(torch.device(d) for d in devices):
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()


def _stack() -> list:
    """The calling thread's open stages. Its native id is read once here
    (a system call, costly in a sandbox) and kept beside them."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        _local.tid = threading.get_native_id()
    return stack


class stage:
    """Time the block as stage `name`; on the cards of `devices` (one
    device or a list) the clock is read after each of their current
    streams has finished its queued work, so a split stage covers all of
    its shards. (A class, not a generator: it is entered on every stage
    call, tracing on or off.)"""

    __slots__ = ("name", "devices", "_range", "_parent", "_t0")

    def __init__(self, name: str, devices=None):
        self.name, self.devices = name, devices

    def __enter__(self) -> None:
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        try:
            _sync(self.devices)
        except BaseException:
            self._close_range()
            raise
        stack = _stack()
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        self._t0 = time.perf_counter_ns()

    def __exit__(self, *exc) -> None:
        _local.stack.pop()
        try:
            _sync(self.devices)
            t1 = time.perf_counter_ns()
            with _lock:
                _times[self.name] += (t1 - self._t0) * 1e-9
                _counts[self.name] += 1
                if len(_intervals) == _intervals.maxlen:
                    _counters["profiling.dropped"] += 1
                _intervals.append((self.name, _local.tid, self._parent,
                                   _run, self._t0, t1))
        finally:
            self._close_range()

    def _close_range(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)


def count(name: str, n=1) -> None:
    """Add `n` to the counter `name`."""
    with _lock:
        _counters[name] += n


def snapshot() -> dict[str, float]:
    with _lock:
        return dict(_times)


def counts() -> dict[str, int]:
    with _lock:
        return dict(_counts)


def counters() -> dict[str, float]:
    with _lock:
        return dict(_counters)


def intervals() -> list[Interval]:
    """The recorded stage calls, oldest first, on the realtime clock."""
    with _lock:
        wall, perf = _anchor
        return [Interval(n, th, par, run, t0 - perf + wall, t1 - perf + wall)
                for n, th, par, run, t0, t1 in _intervals]


def reset() -> None:
    global _anchor
    with _lock:
        _times.clear()
        _counts.clear()
        _counters.clear()
        _intervals.clear()
        _anchor = (time.time_ns(), time.perf_counter_ns())


@contextlib.contextmanager
def command(kind: str):
    """One db or ris command (`kind`): its stages share a new run id, and
    under PRIBLAST_TRACE_DIR, unless a profiler records already, it runs
    under torch.profiler and its Chrome trace is written there as
    <kind>_<pid>_<run>.json."""
    global _run, _runs
    with _lock:
        _runs += 1
        run = _runs
    prev, _run = _run, run
    try:
        trace_dir = os.environ.get("PRIBLAST_TRACE_DIR", "")
        if not trace_dir or torch.autograd._profiler_enabled():
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            yield
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"{kind}_{os.getpid()}_{run}.json")
        prof.export_chrome_trace(path)
        _add_unseen_threads(path, run)
    finally:
        _run = prev


def _add_unseen_threads(path: str, run: int) -> None:
    """The stages of run `run` on threads the profiler did not record,
    added to the Chrome trace at `path` as ranges of their own threads. A
    thread it recorded has ranges or ops of this process; CUDA runtime
    calls are traced on every thread, and device events carry a stream
    id as their tid, so neither marks a thread as recorded."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    pid = os.getpid()
    seen = {e.get("tid") for e in events
            if e.get("ph") == "X" and e.get("pid") == pid
            and e.get("cat") in ("user_annotation", "cpu_op")}
    base = int(trace.get("baseTimeNanoseconds", 0))
    for iv in intervals():
        if iv.run == run and iv.thread not in seen:
            events.append({"ph": "X", "cat": "user_annotation",
                           "name": iv.name, "pid": pid, "tid": iv.thread,
                           "ts": (iv.start - base) / 1e3,
                           "dur": (iv.end - iv.start) / 1e3,
                           "args": {"parent": iv.parent, "run": run}})
    with open(path, "w") as f:
        json.dump(trace, f)


def report() -> str:
    lines = ["stage timings:"]
    with _lock:
        rows = sorted(_times.items(), key=lambda kv: -kv[1])
        for name, total in rows:
            lines.append(f"  {name:32s} {total:9.3f}s  x{_counts[name]}")
        if _counters:
            lines.append("counters:")
            for name, v in sorted(_counters.items()):
                v = f"{v:.3f}" if isinstance(v, float) else str(v)
                lines.append(f"  {name:32s} {v:>10s}")
    return "\n".join(lines)


def maybe_report() -> None:
    if enabled() and (_times or _counters):
        print(report())
