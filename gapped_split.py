#!/usr/bin/env python3
"""Where the gapped stage of the port's `ris` spends its time, on one GPU.

    python3 gapped_split.py [--seed 0] [--reps 10] [--out FILE]

Builds chip_smoke.py's workload (100 queries of ~1,000 nt against 20 db
sequences of ~5,000 nt, from --seed), runs `db` and `ris` (the device
chain) on cuda, and splits `ris.gapped` with synchronised host clocks
into:
  - device work of each direction (`search/gapped.py:_extend_dir`), and
    inside it the time before, in and after the kernel's wrapper
    (`ops/gapped_sweep.py:gapped_extend_dir`);
  - D2H and per-hit coordinates (`gapped_extend_flat_batch` around
    `gapped_extend_both`);
  - the host engine's overflow fallback (`pipeline.OverflowFallback`),
    with the overflowed hits and the threads: its native `gapped_extend`
    calls, which run on threads beside the next batches (their seconds
    summed over the threads, stage `ris.gapped.rerun`), the wait for
    them after the last batch (`ris.gapped.rerun_wait`) and the patch of
    the stream and base pairs (`ris.gapped.patch`); the last two are on
    the stage's path;
  - the rest of `pipeline.gapped_stage` (concatenation and the vectorised
    base-pair assembly).
Then it times one direction's device work (`_extend_dir`, flag 0) on the
inputs of the main path's first gapped batch with CUDA events, and lists
that call's device time by kernel from `torch.profiler`. It also prints
the sha256 of the `ris` body (the output without its three header lines).

Prints one JSON object as its last line; --out also writes it, with the
profiler table, to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("gapped_split: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    import numpy as np

    from priblast_tpu_torch import cli
    from priblast_tpu_torch.ops import gapped_sweep as sweep_op
    from priblast_tpu_torch.ops import native
    from priblast_tpu_torch.search import gapped, pipeline
    from priblast_tpu_torch.utils import profiling as prof

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    native.build()
    sweep_op.build()

    work = HERE / "build" / "gapped_split"
    work.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    db_lens = cs.DB_LEN + rng.integers(-cs.DB_LEN // 25, cs.DB_LEN // 25 + 1,
                                       cs.N_DB)
    q_lens = cs.Q_LEN + rng.integers(-cs.Q_LEN // 25, cs.Q_LEN // 25 + 1,
                                     cs.N_Q)
    cs.write_fasta(work / "db.fa", "t", cs.markov_batch(rng, db_lens))
    cs.write_fasta(work / "q.fa", "q", cs.markov_batch(rng, q_lens))
    t0 = time.perf_counter()
    cli.main(["db", "-i", str(work / "db.fa"), "-o", str(work / "db")])
    t_db = time.perf_counter() - t0

    def sync_now():
        torch.cuda.synchronize()
        return time.perf_counter()

    acc = {k: 0.0 for k in ("extend_dir", "before_entry", "entry",
                            "after_entry", "extend_both", "flat_batch",
                            "overflow_fallback", "gapped_stage")}
    marks, first = {}, []
    batches, overflowed, threads_seen = [], [], []

    def timed(key, fn, sync=True):
        def run(*a, **k):
            t = sync_now() if sync else time.perf_counter()
            out = fn(*a, **k)
            acc[key] += (sync_now() if sync else time.perf_counter()) - t
            return out
        return run

    ext0, entry0 = gapped._extend_dir, sweep_op.gapped_extend_dir

    def ext_rec(*a, **k):
        if not first and k.get("flag") == 0:
            first.append((a, k))
        t = sync_now()
        out = ext0(*a, **k)
        t1 = sync_now()
        acc["extend_dir"] += t1 - t
        acc["before_entry"] += marks["in"] - t
        acc["after_entry"] += t1 - marks["out"]
        return out

    def entry_rec(*a, **k):
        marks["in"] = sync_now()
        out = entry0(*a, **k)
        marks["out"] = sync_now()
        acc["entry"] += marks["out"] - marks["in"]
        return out

    both0 = gapped.gapped_extend_both
    flat0 = gapped.gapped_extend_flat_batch

    def flat_rec(hits, *a, **k):
        batches.append(len(hits["q_sp"]))
        return timed("flat_batch", flat0)(hits, *a, **k)

    # the fallback's parts are stages (ris.gapped.rerun summed over its
    # threads, .rerun_wait, .patch); its submissions count the overflows
    sub0 = pipeline.OverflowFallback.submit

    def submit_rec(self, overflow, start=0):
        overflowed.append(int(np.count_nonzero(overflow)))
        return sub0(self, overflow, start)

    gst0 = pipeline.gapped_stage

    def gst_rec(*a, **k):
        threads_seen.append(k.get("threads", 1))
        return timed("gapped_stage", gst0)(*a, **k)

    patches = [(gapped, "_extend_dir", ext_rec),
               (sweep_op, "gapped_extend_dir", entry_rec),
               (gapped, "gapped_extend_both", timed("extend_both", both0)),
               (gapped, "gapped_extend_flat_batch", flat_rec),
               (pipeline.OverflowFallback, "submit", submit_rec),
               (pipeline, "gapped_stage", gst_rec)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    prof.reset()
    # the device chain (the ris router's default, auto, may send queries
    # to the host chain)
    os.environ["PRIBLAST_DEVICE_EXTEND"] = "1"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        cli.main(["ris", "-i", str(work / "q.fa"), "-o",
                  str(work / "ris.txt"), "-d", str(work / "db")])
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    t_ris = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stages = prof.snapshot()
    n_lines = len(cs.body(work / "ris.txt"))
    body_sha = cs.body_sha256(work / "ris.txt")

    fallback = {"overflowed hits": sum(overflowed),
                "gapped hits": sum(batches),
                "threads": threads_seen}
    wait = stages.get("ris.gapped.rerun_wait", 0.0)
    patch = stages.get("ris.gapped.patch", 0.0)
    acc["overflow_fallback"] = wait + patch
    fallback.update({
        "native gapped_extend calls, summed over the threads":
            stages.get("ris.gapped.rerun", 0.0),
        "their wait after the last batch (not hidden)": wait,
        "patch": patch,
        "on the stage's path (wait + patch)": wait + patch})

    split = {
        "extend_dir device work (both directions, all batches)":
            acc["extend_dir"],
        "  before gapped_extend_dir": acc["before_entry"],
        "  gapped_extend_dir": acc["entry"],
        "  after gapped_extend_dir": acc["after_entry"],
        "extend_both outside extend_dir (column stacks)":
            acc["extend_both"] - acc["extend_dir"],
        "D2H + per-hit coordinates (flat_batch outside extend_both)":
            acc["flat_batch"] - acc["extend_both"],
        "overflow fallback (host engine), on the stage's path":
            acc["overflow_fallback"],
        "concat + vectorised assembly (rest of gapped_stage)":
            acc["gapped_stage"] - acc["flat_batch"]
            - acc["overflow_fallback"],
        "gapped_stage total": acc["gapped_stage"],
    }

    # one direction's device work on the first batch, CUDA events
    a, k = first[0]
    B = int(a[0].shape[0])
    ms = cs.cuda_ms(lambda: gapped._extend_dir(*a, **k), args.reps)
    from torch.profiler import ProfilerActivity, profile

    gapped._extend_dir(*a, **k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as pr:
        gapped._extend_dir(*a, **k)
        torch.cuda.synchronize()
    ka = pr.key_averages()

    def dev_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, name):
                return float(getattr(e, name))
        return 0.0

    rows = sorted(((dev_us(e), e.count, e.key) for e in ka), reverse=True)
    dev_total_ms = sum(r[0] for r in rows) / 1e3
    try:
        table = ka.table(sort_by="self_device_time_total", row_limit=25)
    except Exception:
        table = ka.table(sort_by="self_cuda_time_total", row_limit=25)

    rec = dict(card=card, torch=torch.__version__, db_s=t_db, ris_s=t_ris,
               ris_q_per_s=cs.N_Q / t_ris, lines=n_lines,
               body_sha256=body_sha, fallback=fallback,
               peak_gb_ris=peak_gb, gapped_batches=batches,
               stages=stages, split_s=split,
               one_direction=dict(B=B, dtype=k.get("dtype"),
                                  max_ext=k.get("max_ext"),
                                  event_ms=ms, reps=args.reps,
                                  profiler_device_ms=dev_total_ms,
                                  top_kernels=[(round(us, 1), n, name)
                                               for us, n, name in rows[:8]]))
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=1) + "\n\n" + table + "\n")
    for key, v in split.items():
        print(f"[split] {key}: {v:.4f} s ({card})", flush=True)
    print(f"[fallback] {json.dumps(fallback)} ({card})", flush=True)
    print(f"[body] ris {n_lines} lines, sha256 {body_sha}; ris {t_ris:.3f} "
          f"s ({card})", flush=True)
    print(f"[one direction] B={B} {k.get('dtype')} max_ext="
          f"{k.get('max_ext')}: {ms:.4f} ms (CUDA events, {args.reps} reps); "
          f"profiler device sum {dev_total_ms:.4f} ms ({card})", flush=True)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
