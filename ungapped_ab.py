#!/usr/bin/env python3
"""The ungapped-extension kernel against its parent version and variants,
on one GPU, on the main path's first ungapped launch.

    python3 ungapped_ab.py [--parent FILE] [--seed 0] [--reps 20]
                           [NAME=SRC[@FLAG,FLAG...] ...]

Builds, with the wrapper's nvcc flags and -Xptxas -v (registers and
spills: `[build]` lines): the parent's
priblast_tpu_torch/csrc/ungapped_extend.cu (--parent, else `git show
HEAD:` of it; the card's copy has no .git, so write the file first), the
committed one, and each NAME=SRC variant (a source with the same C
interface; @FLAG,... adds nvcc flags, e.g. @-maxrregcount=56).

The batch is the inputs of the first ungapped launch of chip_smoke.py's
workload from --seed (`db`, then `ris` up to that launch, on cuda). Every
build must equal search/ungapped.py:ungapped_extend_flat bit for bit on
it, on its first 4096+37 hits (the ragged batch) and on two permutations
of it, which are diagnostics: the hits sorted by their plain step counts
(how much the warps' spread of steps costs) and by qb + q_sp (how much
the scattered query gathers cost).

Prints the lane efficiency of one thread per hit on each of those
orders: the steps of all hits over 32 x the sum, over warps of 32
consecutive hits, of the warp's largest step count
(search/ungapped.py:extend_steps). Then every build is timed with
CUDA events in turns (first to last, then last to first) on each batch:
`[ab]` lines with ms and the multiple of chip_smoke.py's bound. One JSON
object last. A variant that does not build or differs from the plain
version is reported and left out; the committed one must pass.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC_REL = "priblast_tpu_torch/csrc/ungapped_extend.cu"
RAGGED = 4096 + 37


class _Captured(Exception):
    """Raised by the recorder once it holds the first launch's inputs, so
    that `ris` stops there."""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", metavar="NAME=SRC[@FLAG,...]")
    ap.add_argument("--parent", help="the parent's ungapped_extend.cu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ungapped_ab: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from priblast_tpu_torch import cli
    from priblast_tpu_torch.ops import access_scan as acs
    from priblast_tpu_torch.ops import native, nvcc
    from priblast_tpu_torch.ops import ungapped_extend as uop
    from priblast_tpu_torch.search import ungapped as ung

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out_dir = HERE / "build" / "ungapped_ab"
    out_dir.mkdir(parents=True, exist_ok=True)

    parent = Path(args.parent) if args.parent else out_dir / "parent.cu"
    if not args.parent:
        parent.write_text(subprocess.run(
            ["git", "show", f"HEAD:{SRC_REL}"], cwd=HERE, check=True,
            capture_output=True, text=True).stdout)
    specs = {"parent": (parent, []), "committed": (uop._SRC, [])}
    for v in args.variants:
        name, _, spec = v.partition("=")
        src, _, flags = spec.partition("@")
        specs[name] = (Path(src), [f for f in flags.split(",") if f])
    regs = {}

    def build(name, src, extra):
        so = out_dir / f"lib_{name}.so"
        r = subprocess.run(
            [nvcc.shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc",
             *uop.NVCC_FLAGS, *extra, "-Xptxas", "-v", "-o", str(so),
             str(src)], capture_output=True, text=True)
        if r.returncode != 0:
            print(f"ungapped_ab: {name} does not build:\n{r.stderr}",
                  file=sys.stderr)
            return name, None
        # the first kernel of the source: the launched one
        part = (r.stderr.split("Compiling entry function")[1:] or [""])[0]
        regs[name] = " ".join(ln.split(":", 1)[-1].strip()
                              for ln in part.splitlines()
                              if "registers" in ln or "spill" in ln)
        lib = ctypes.CDLL(str(so))
        lib.ungapped_extend.restype = ctypes.c_int
        lib.ungapped_extend.argtypes = [ctypes.c_void_p] * 4
        return name, lib

    with cf.ThreadPoolExecutor(len(specs) + 3) as ex:
        futs = [ex.submit(build, n, s, f) for n, (s, f) in specs.items()]
        side = [ex.submit(fn) for fn in (native.build, acs.build_inside,
                                         acs.build_outside)]
        libs = {n: lib for n, lib in (f.result() for f in futs) if lib}
        for f in side:
            f.result()
    if "committed" not in libs:
        return 1
    for name in libs:
        print(f"[build] {name}: {regs[name]}", flush=True)

    # ---- the main path's first ungapped launch -------------------------
    work = out_dir / "work"
    work.mkdir(exist_ok=True)
    rng = np.random.default_rng(args.seed)
    db_lens = cs.DB_LEN + rng.integers(-cs.DB_LEN // 25, cs.DB_LEN // 25 + 1,
                                       cs.N_DB)
    q_lens = cs.Q_LEN + rng.integers(-cs.Q_LEN // 25, cs.Q_LEN // 25 + 1,
                                     cs.N_Q)
    cs.write_fasta(work / "db.fa", "t", cs.markov_batch(rng, db_lens))
    cs.write_fasta(work / "q.fa", "q", cs.markov_batch(rng, q_lens))
    first, entry = [], uop.ungapped_extend

    def rec(*a):
        first.append(a)
        raise _Captured

    cli.main(["db", "-i", str(work / "db.fa"), "-o", str(work / "db")])
    uop.ungapped_extend = rec
    # the device chain (the ris router's default, auto, may send queries
    # to the host chain)
    os.environ["PRIBLAST_DEVICE_EXTEND"] = "1"
    try:
        cli.main(["ris", "-i", str(work / "q.fa"), "-o",
                  str(work / "ris.txt"), "-d", str(work / "db")])
    except _Captured:
        pass
    finally:
        uop.ungapped_extend = entry
    if not first:
        print("ungapped_ab: no ungapped launch captured", file=sys.stderr)
        return 1
    a0 = first[0]
    B = a0[0].shape[0]
    stream = torch.cuda.current_stream().cuda_stream

    def permuted(a, perm):
        return tuple(x[perm].contiguous() if torch.is_tensor(x) else x
                     for x in a)

    def run(name, a):
        bufs, dbufs, d, dropout = a[11:]
        flat = (bufs[0], dbufs[0], bufs[1], bufs[2], dbufs[1], dbufs[2])
        return uop._call(libs[name].ungapped_extend, (*a[0:4], *a[6:11]),
                         a[4], a[5], flat, stream, d, dropout)

    ref = ung.ungapped_extend_flat(*a0)
    left, right = ung.extend_steps(*a0)
    steps = left + right
    by_steps = torch.argsort(steps, stable=True)
    by_query = torch.argsort(a0[6] + a0[0], stable=True)
    batches = {
        "main": (a0, ref),
        "ragged": (tuple(x[:RAGGED].contiguous() if torch.is_tensor(x)
                         else x for x in a0),
                   {k: v[:RAGGED] for k, v in ref.items()}),
        "by_steps": (permuted(a0, by_steps),
                     {k: v[by_steps] for k, v in ref.items()}),
        "by_query": (permuted(a0, by_query),
                     {k: v[by_query] for k, v in ref.items()}),
    }
    for name in list(libs):
        for label, (a, r) in batches.items():
            got = run(name, a)
            bad = [k for k in r if not torch.equal(got[k], r[k])]
            if bad:
                print(f"ungapped_ab: {name} differs from the plain version "
                      f"in {bad} ({label} batch)", file=sys.stderr)
                if name == "committed":
                    return 1
                del libs[name]
                break

    perms = {"main": slice(None), "by_steps": by_steps, "by_query": by_query}
    eff = {label: cs.lanes_one_per_hit(steps[p]) for label, p in perms.items()}
    print(f"[lanes] one thread per hit: lane efficiency main "
          f"{eff['main']:.4f}, hits sorted by steps {eff['by_steps']:.4f}, "
          f"by qb + q_sp {eff['by_query']:.4f}; steps per hit mean "
          f"{float(steps.float().mean()):.2f} max {int(steps.max())} "
          f"(B = {B})", flush=True)

    bounds = {"main": cs.ungapped_bound_ms(a0, (left, right))[0]}
    bounds["ragged"] = cs.ungapped_bound_ms(
        batches["ragged"][0], (left[:RAGGED], right[:RAGGED]))[0]
    bounds["by_steps"] = bounds["by_query"] = bounds["main"]
    print(f"[bound] main {bounds['main']:.6f} ms, ragged "
          f"{bounds['ragged']:.6f} ms", flush=True)

    times = {}
    order = list(libs)
    for label, (a, _r) in batches.items():
        for names in (order, order[::-1]):
            for name in names:
                ms = cs.cuda_ms(lambda: run(name, a), args.reps)
                times.setdefault(name, {}).setdefault(label, []).append(ms)
                print(f"[ab] {name} {label}: {ms:.4f} ms, "
                      f"{ms / bounds[label]:.2f}x bound ({card})", flush=True)
    print(json.dumps(dict(
        card=card, B=B, ragged=RAGGED, bounds_ms=bounds,
        lane_efficiency_one_per_hit=eff,
        variants={n: [str(s), f] for n, (s, f) in specs.items()},
        registers=regs, times_ms=times,
        at=time.strftime("%Y-%m-%dT%H:%M:%S"))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
