"""The measured window, the same for every traffic kind: jobs back to back
from the first until `--seconds` have passed, the last run to its end,
the window ending with it; under torch.profiler in a traced run and in a
cell with an end-to-end metric from the trace (`run.profile`)."""

from __future__ import annotations

import contextlib
import os
import time

from pbench import devtrace


def measure(run, plan) -> None:
    """Runs the jobs plan(0), plan(1), ... and fills `run`: its jobs,
    attempted and failed counts, window, spans, work and trace. plan(i)
    gives (record, call, note): the job's record (with its nucleotides
    `nt` and the units it attempts, `units`), the call that runs it, and a
    function giving the job's log line after it ran (or None)."""
    import torch
    from priblast_tpu_torch.utils import profiling

    trace = (devtrace.profiled(run.tmp / "trace.json") if run.profile
             else contextlib.nullcontext())
    profiling.reset()
    with trace:
        t_start = time.perf_counter()
        i = 0
        while True:
            rec, call, note = plan(i)
            t = time.perf_counter()
            try:
                call()
                rec["ok"] = True
            except Exception as e:  # a job that fails is counted, not hidden
                run.log(f"[job {i}] failed: {e!r}")
                rec["ok"] = False
            rec["s"] = time.perf_counter() - t
            run.jobs.append(rec)
            run.attempted += rec["units"]
            run.failed += 0 if rec["ok"] else rec["units"]
            line = note(rec) if note else None
            if line:
                run.log(f"[job {i}] {line}")
            i += 1
            if time.perf_counter() - t_start >= run.seconds:
                break
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        run.window_s = time.perf_counter() - t_start
    run.spans = profiling.snapshot()
    run.work_nt = float(sum(j["nt"] for j in run.jobs))
    run.log(f"[window] {len(run.jobs)} jobs, {run.work_nt:.0f} nt, "
            f"{run.window_s:.3f} s")
    if run.profile:
        run.devtrace = devtrace.Trace(run.tmp / "trace.json")
        os.remove(run.tmp / "trace.json")
