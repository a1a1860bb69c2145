#!/usr/bin/env python3
"""The fused stage's kernels (csrc/fused_expand.cu: the expansion and the
threshold) against variants, on one GPU, on the main path's first pair
block.

    python3 fused_ab.py [--seed 0] [--reps 5] [NAME=SRC[@FLAG,...] ...]

Builds, with the wrapper's nvcc flags and -Xptxas -v (registers and
spills per kernel: `[build]` lines), the committed source and each
NAME=SRC variant (a source with the same C interface; @FLAG,... adds
nvcc flags, e.g. @-maxrregcount=64). The block is the first pair block of
the main path's wave of chip_smoke.py's workload from --seed (written,
and its `db` run, where build/chip_smoke lacks them; then `ris` on cuda up
to the fused stage). Every build must give search/fused.py:_expand_core's
columns bit for bit on it and, on the ungapped kernel's output for them,
_thresh_core's records; a variant that does not build or differs is
reported and left out, the committed one must pass. Then each build's
expansion (through expand_call: its launch and its one read) and
threshold launch are timed with CUDA events in turns (first build to
last, then last to first) at several threads per CTA, the default grid:
`[ab]` lines, then one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
EXPAND_THREADS = (64, 128, 256)
THRESH_THREADS = (256, 512, 1024)


class _Captured(Exception):
    """Raised once the fused stage's inputs are held, so that `ris` stops
    there."""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", metavar="NAME=SRC[@FLAG,...]")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fused_ab: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from priblast_tpu_torch import cli
    from priblast_tpu_torch.ops import fused_expand as fexp
    from priblast_tpu_torch.ops import nvcc
    from priblast_tpu_torch.ops import ungapped_extend as uop
    from priblast_tpu_torch.search import fused

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out_dir = HERE / "build" / "fused_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    specs = {"committed": (fexp.SRC, [])}
    for v in args.variants:
        name, _, spec = v.partition("=")
        src, _, flags = spec.partition("@")
        specs[name] = (Path(src), [f for f in flags.split(",") if f])
    libs, regs = {}, {}
    for name, (src, extra) in specs.items():
        so = out_dir / f"lib_{name}.so"
        r = subprocess.run(
            [nvcc.shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc",
             *fexp.NVCC_FLAGS, *extra, "-Xptxas", "-v", "-o", str(so),
             str(src)], capture_output=True, text=True)
        if r.returncode != 0:
            print(f"fused_ab: {name} does not build:\n{r.stderr}",
                  file=sys.stderr)
            if name == "committed":
                return 1
            continue
        regs[name] = "; ".join(
            ("expand" if "expand_kernel" in part else "threshold") + ": "
            + " ".join(ln.split(":", 1)[-1].strip()
                       for ln in part.splitlines()
                       if "registers" in ln or "spill" in ln)
            for part in r.stderr.split("Compiling entry function")[1:])
        libs[name] = fexp.bind(ctypes.CDLL(str(so)))
        print(f"[build] {name}: {regs[name]}", flush=True)

    # ---- the main path's fused stage inputs ----------------------------
    work = HERE / "build" / "chip_smoke"
    db = work / "db_gpu"
    if not (work / "q.fa").is_file():
        cs.write_workload(work, args.seed)
    if not (work / "db_gpu.bas").is_file():
        cli.main(["db", "-i", str(work / "db.fa"), "-o", str(db)])
    first, entry = [], fused.fused_stage

    def rec(*a, **k):
        first.append(a)
        raise _Captured

    fused.fused_stage = rec
    os.environ["PRIBLAST_DEVICE_EXTEND"] = "1"
    try:
        cli.main(["ris", "-i", str(work / "q.fa"), "-o",
                  str(out_dir / "ris.txt"), "-d", str(db)])
    except _Captured:
        pass
    finally:
        fused.fused_stage = entry
    if not first:
        print("fused_ab: no fused stage captured", file=sys.stderr)
        return 1
    p, cands, qp, dp = first[0]
    dev = torch.device("cuda")
    wb = fused._WaveBuffers(cands, qp, dp, dev)
    block = min(fused.block_cap(dev), wb.tot)
    eargs = (p.min_accessible_length, p.max_seed_length, 0, block, wb, qp,
             dp)
    thr = p.interaction_energy_threshold
    stream = torch.cuda.current_stream().cuda_stream
    hits = fused._expand_core(*eargs)
    res = uop.ungapped_extend(
        hits["q_sp"], hits["db_sp"], hits["length"], hits["dbseq_start"],
        hits["acc_e"].float(), hits["hyb_e"].float(), hits["qb"],
        hits["qab"], hits["dbb"], hits["aoff"], hits["coff"], qp.bufs,
        dp.bufs, p.min_accessible_length, p.drop_out_length_wo_gap)
    rec_p = fused._thresh_core(p, res, hits)

    for name in list(libs):
        lib, bad = libs[name], []
        try:
            for threads in EXPAND_THREADS:
                got = fexp.expand_call(lib, *eargs, stream, threads)
                bad += [f"{k} at {threads}" for k in hits
                        if not torch.equal(got[k].view(torch.int64),
                                           hits[k].view(torch.int64))]
            for threads in THRESH_THREADS:
                got = fexp.threshold_call(lib, thr, res, hits, stream,
                                          threads)
                bad += [f"{k} at {threads}" for k in rec_p
                        if got[k].dtype != rec_p[k].dtype
                        or not np.array_equal(got[k].view(np.uint8),
                                              rec_p[k].view(np.uint8))]
        except RuntimeError as e:  # a launch the variant refuses
            bad.append(str(e))
        if bad:
            print(f"fused_ab: {name} differs from the plain versions: "
                  f"{bad[:6]}", file=sys.stderr)
            if name == "committed":
                return 1
            del libs[name]
    got = None

    # ---- times in turns --------------------------------------------------
    order = list(libs) + list(reversed(libs))
    times = {name: {} for name in libs}
    for kernel, all_threads in (("expand", EXPAND_THREADS),
                                ("threshold", THRESH_THREADS)):
        for threads in all_threads:
            for name in order:
                lib = libs[name]
                if kernel == "expand":
                    def call():
                        fexp.expand_call(lib, *eargs, stream, threads)
                else:
                    def call():
                        fexp.threshold_launch(lib, thr, res, hits, stream,
                                              threads)
                times[name].setdefault(f"{kernel} {threads}", []).append(
                    cs.cuda_ms(call, args.reps))
    for name, by in times.items():
        print(f"[ab] {name}: " + "; ".join(
            f"{k} " + " / ".join(f"{v:.4f}" for v in vs)
            for k, vs in by.items()) + f" ms ({block} pairs, "
            f"{len(hits['pid'])} survivors, {len(rec_p['pid'])} kept; the "
            f"expansion through expand_call, the threshold's launch) "
            f"({card})", flush=True)
    print(json.dumps({"card": card, "block": block, "regs": regs,
                      "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
