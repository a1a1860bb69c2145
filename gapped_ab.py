#!/usr/bin/env python3
"""Variants of the gapped-extension kernel against the committed one, on
one GPU, on the main path's first gapped batch.

    python3 gapped_ab.py [--batch FILE] [--reps 20] [--dtypes float32,...]
        NAME=SRC[,MAXRREG][@FLAG,...] ...

Each NAME=SRC is a CUDA source with the C interface of
priblast_tpu_torch/csrc/gapped_extend.cu (for example that file after a
one-line sed, or the parent commit's); it is built with the wrapper's nvcc
flags, with -maxrregcount=MAXRREG in place of the wrapper's value when
MAXRREG is given (0: no cap), and the FLAGs added. The batch is the inputs
of the first gapped launch of chip_smoke.py's workload (`db` + `ris` on
cuda from --seed), saved to --batch and read from there when the file
exists. Every variant must give the committed kernel's integers, floats
and traceback lists on that batch in float32 and float64 at max_ext 32, 64
and 120, and the committed kernel must give its plain version's, whose
work it counts (`gapped_sweep.count_work`). Then all are timed with CUDA
events in turns (forward, then backward) in each of --dtypes (at the
batch's max_ext), except builds with
-DGAPPED_STAMPS: their sums (`gapped_extend_stamps`) on the batch give the
split of the kernel's time by part, per hit and per diagonal (`[split]`).
The committed build also gets the committed source built with
-DGAPPED_STAMPS (`committed+stamps`). Prints one JSON object last.
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
# the -DGAPPED_STAMPS build's sums, in the kernel's kS* order
STAMP_KEYS = ("hits", "diagonals", "band", "admitted", "combos", "steps",
              "empty", "busiest", "rounds", "nopred", "cyc_hit", "cyc_pre",
              "cyc_admit", "cyc_combo", "cyc_fallback", "cyc_rest",
              "cyc_post")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*",
                    metavar="NAME=SRC[,MAXRREG][@FLAG,...]")
    ap.add_argument("--batch", default=str(HERE / "build" / "gapped_ab" /
                                           "batch.pt"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtypes", default="float32",
                    help="the dtypes timed, comma-separated")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gapped_ab: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from priblast_tpu_torch import cli
    from priblast_tpu_torch.ops import gapped_sweep as sop
    from priblast_tpu_torch.ops import native

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out_dir = Path(args.batch).resolve().parent
    out_dir.mkdir(parents=True, exist_ok=True)

    def build(name, spec):
        spec, _, extra = spec.partition("@")
        src, _, cap = spec.partition(",")
        flags = [f for f in sop.NVCC_FLAGS if not f.startswith("-maxrreg")]
        if cap and int(cap) > 0:
            flags.append(f"-maxrregcount={int(cap)}")
        elif not cap:
            flags = list(sop.NVCC_FLAGS)
        flags += [f for f in extra.split(",") if f]
        so = out_dir / f"lib_{name}.so"
        r = subprocess.run(["/usr/local/cuda/bin/nvcc", *flags, "-Xptxas",
                            "-v", "-o", str(so), src], capture_output=True,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr}")
        # registers and spill stores of the float, dropout-16, max_ext<=32
        # instantiation (the main path's)
        log = r.stderr.split("Compiling entry function")
        for part in log:
            if "extend_kernelIfLi16ELi1E" in part.split("\n")[0]:
                regs[name] = " ".join(
                    ln.strip() for ln in part.splitlines()
                    if "registers" in ln or "spill" in ln)
        lib = ctypes.CDLL(str(so))
        for fn in ("gapped_extend_f32", "gapped_extend_f64"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [ctypes.c_void_p] * 4
        if "-DGAPPED_STAMPS" in flags:
            lib.gapped_extend_stamps.restype = ctypes.c_int
            lib.gapped_extend_stamps.argtypes = [ctypes.c_void_p]
            stamped.add(name)
        return name, lib

    specs = dict(v.split("=", 1) for v in args.variants)
    specs["committed"] = str(sop._SRC)
    specs["committed+stamps"] = f"{sop._SRC}@-DGAPPED_STAMPS"
    stamped = set()
    regs = {}
    with cf.ThreadPoolExecutor(len(specs) + 2) as ex:
        futs = [ex.submit(build, n, s) for n, s in specs.items()]
        ex.submit(native.build).result()
        libs = dict(f.result() for f in futs)
    libs = {"committed": libs.pop("committed"), **libs}
    for name, r in regs.items():
        print(f"[build] {name}: {r}", flush=True)

    batch = Path(args.batch)
    if batch.exists():
        a0, k0 = torch.load(batch)
        a0 = tuple(t.cuda() for t in a0)
    else:
        work = out_dir / "work"
        work.mkdir(exist_ok=True)
        rng = np.random.default_rng(args.seed)
        db_lens = cs.DB_LEN + rng.integers(-cs.DB_LEN // 25,
                                           cs.DB_LEN // 25 + 1, cs.N_DB)
        q_lens = cs.Q_LEN + rng.integers(-cs.Q_LEN // 25,
                                         cs.Q_LEN // 25 + 1, cs.N_Q)
        cs.write_fasta(work / "db.fa", "t", cs.markov_batch(rng, db_lens))
        cs.write_fasta(work / "q.fa", "q", cs.markov_batch(rng, q_lens))
        first, entry = [], sop.gapped_extend_dir

        def rec(*a, **k):
            if not first:
                first.append((a, k))
            return entry(*a, **k)

        sop.gapped_extend_dir = rec
        # the device chain (the ris router's default, auto, may send queries
        # to the host chain)
        os.environ["PRIBLAST_DEVICE_EXTEND"] = "1"
        try:
            cli.main(["db", "-i", str(work / "db.fa"), "-o",
                      str(work / "db")])
            cli.main(["ris", "-i", str(work / "q.fa"), "-o",
                      str(work / "ris.txt"), "-d", str(work / "db")])
        finally:
            sop.gapped_extend_dir = entry
        a0, k0 = first[0]
        torch.save(([t.cpu() for t in a0], k0), batch)
    stream = torch.cuda.current_stream().cuda_stream

    def run(name, k):
        lib = libs[name]
        fn = (lib.gapped_extend_f32 if k.get("dtype", "float32") == "float32"
              else lib.gapped_extend_f64)
        kw = {x: k[x] for x in ("flag", "d", "dropout", "min_helix",
                                "max_ext")}
        return sop._call(fn, a0, stream, dtype=k.get("dtype", "float32"),
                         **kw)

    def same(x, y):
        return all(torch.equal(p, q) for p, q in zip(x, y))

    work = {}
    if not same(run("committed", k0),
                sop.extend_dir_plain(*a0, **k0, counts=work)):
        print("gapped_ab: the committed kernel differs from its plain "
              "version", file=sys.stderr)
        return 1
    for dtype, me in (("float32", 32), ("float64", 32), ("float32", 64),
                      ("float64", 120)):
        k = dict(k0, dtype=dtype, max_ext=me)
        ref = run("committed", k)
        for name in libs:
            if not same(run(name, k), ref):
                print(f"gapped_ab: {name} differs from the committed kernel "
                      f"({dtype}, max_ext={me})", file=sys.stderr)
                return 1

    # the work-list form's work and the split of the time by part, per hit
    # and per diagonal, from each stamped build (the parent's counts only
    # its cycles)
    B = int(a0[0].shape[0])
    nd = max(work["diagonals"], 1)
    print(f"[work] B={B} per hit: diagonals {work['diagonals'] / B:.3f}, "
          f"band cells {work['band'] / B:.2f}, admitted "
          f"{work['admitted'] / B:.3f}, combos {work['combos'] / B:.3f}, "
          f"rounds {work['rounds'] / B:.3f}, admitted cells without a "
          f"finite predecessor {work['nopred'] / B:.3f}; per diagonal: band "
          f"{work['band'] / nd:.3f}, admitted {work['admitted'] / nd:.4f}, "
          f"combos "
          f"{work['combos'] / nd:.4f}; lane efficiency of the work list "
          f"{work['combos'] / max(32 * work['rounds'], 1):.4f}; (cell, s) "
          f"steps {work['steps'] / B:.2f} a hit, empty "
          f"{work['empty'] / max(work['steps'], 1):.4f}; the busiest "
          f"cell's combos summed over s {work['busiest'] / B:.3f} a hit (a "
          f"lane-per-cell loop's longest lane) against "
          f"{work['combos'] / max(work['admitted'], 1):.3f} combos per "
          f"admitted cell", flush=True)
    split = {}
    for name in sorted(stamped):
        out = (ctypes.c_ulonglong * len(STAMP_KEYS))()
        lib = libs[name]
        lib.gapped_extend_stamps(out)                         # clear
        run(name, k0)
        torch.cuda.synchronize()
        if lib.gapped_extend_stamps(out) != 0:
            print(f"gapped_ab: no stamps from {name}", file=sys.stderr)
            return 1
        st = dict(zip(STAMP_KEYS, (int(v) for v in out)))
        hits, diags = max(st["hits"], 1), max(st["diagonals"], 1)
        split[name] = st
        parts = ("cyc_pre", "cyc_admit", "cyc_combo", "cyc_fallback",
                 "cyc_rest", "cyc_post")
        print(f"[split] {name}: {st['hits']} hits, {st['diagonals']} "
              f"diagonals; lane 0's cycles per hit {st['cyc_hit'] / hits:.0f}"
              f" = " + ", ".join(f"{p[4:]} {st[p] / hits:.0f}" for p in parts)
              + "; per diagonal " + ", ".join(
                  f"{p[4:]} {st[p] / diags:.1f}" for p in parts[1:5])
              + (f"; counted: combos {st['combos']}, rounds {st['rounds']}, "
                 f"equal to the plain version's: "
                 f"{all(st[k] == work[k] for k in sop.WORK_KEYS)}"
                 if st["combos"] or st["rounds"] else "") + f" ({card})",
              flush=True)
    warps = ctypes.c_int(0)
    wfn = libs["committed"].gapped_extend_warps
    wfn.restype = ctypes.c_int
    wfn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    in_flight = {}
    for dtype, me in (("float32", 32), ("float64", 32), ("float32", 64),
                      ("float64", 120)):
        k = dict(k0, dtype=dtype, max_ext=me)
        kw = {x: k[x] for x in ("flag", "d", "dropout", "min_helix",
                                "max_ext")}
        calls = []
        sop._call(lambda *c: calls.append(c) or 0, a0, stream, dtype=dtype,
                  **kw)
        ptrs, sizes, ipar, _ = calls[0]
        if wfn(ptrs, sizes, ipar, dtype == "float64",
               ctypes.byref(warps)) != 0:
            print("gapped_ab: gapped_extend_warps failed", file=sys.stderr)
            return 1
        in_flight[f"{dtype}/{me}"] = warps.value
    print(f"[warps] committed: warps in flight per SM {in_flight}", flush=True)

    times = {}
    order = [n for n in libs if n not in stamped]
    for dtype in args.dtypes.split(","):
        k = dict(k0, dtype=dtype)
        for names in (order, order[::-1]):
            for name in names:
                ms = cs.cuda_ms(lambda: run(name, k), args.reps)
                times.setdefault(f"{name}/{dtype}", []).append(ms)
                print(f"[ab] {name} {dtype}: {ms:.4f} ms ({card})",
                      flush=True)
    print(json.dumps(dict(card=card, B=int(a0[0].shape[0]),
                          dtype=k0.get("dtype"), max_ext=k0["max_ext"],
                          variants=specs, registers=regs, times_ms=times,
                          work=work, split=split, warps_in_flight=in_flight,
                          at=time.strftime("%Y-%m-%dT%H:%M:%S"))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
