#!/usr/bin/env python3
"""An accessibility kernel (a column scan or the probability pass)
against its parent version and variants, on one GPU, on the main path's
first db batch and first ris batch; then the three kernels as committed on
all four of the main path's batches.

    python3 access_ab.py [--kernel outside|inside|prob|grids] [--parent FILE]
                         [--parent-threads 256] [--reps 5]
                         [--threads 768,512] [--tile N]
                         [NAME=SRC[@THREADS] ...]

Builds, with the wrapper's nvcc flags, for --kernel (default outside):
the parent's priblast_tpu_torch/csrc/access_<kernel>.cu (--parent, else
`git show HEAD:` of it), the committed one, each NAME=SRC variant (a
source with the same C interface), and a stamped build (-DACCESS_STAMPS)
of every source that has the stamp hooks. Each build runs at its own
threads per CTA: the parent at --parent-threads (what its wrapper
launched), a variant at @THREADS, else the first --threads (default: the
wrapper's); the committed one also at the other --threads; for prob,
every build but the parent at --tile columns per CTA where given. The
batches are those of `chip_smoke.py`'s workload from --seed (its first `db`
batch, 16 x 6,145 columns, and the first `ris` batch, 64 x 1,281). Every
build must give its plain version's outputs within 1e-4 relative in
float32 and window energies within 2e-3 kcal/mol:
- outside: the planes of `outside_pass`, on the outside inputs made from
  the inside kernel's planes, as on the main path; the energies with the
  plain inside planes;
- inside: the six planes, A and B of `inside_plain` (inside_pass, then
  b_outer_scan); the energies through the plain outside pass on the
  build's own planes (~12 s per build on the db batch);
- prob: p_w and p_w1 of `scan_probabilities` on the scan kernels' planes,
  as on the main path, and their window energies.
Then all are timed with CUDA events in turns (first to last, then last
to first); for prob also split by launch (window and sum kernel) with
torch.profiler.

Prints per build and batch: ms, us per column step, x its bound (prob:
`chip_smoke.prob_bound_ms`) and, for prob, `[launches]` lines with the
window and sum kernels' device ms; per
stamped build the stage split (work: from the previous barrier to the
last thread's arrival; barrier: from there to thread 0's exit; the inside
kernel's backward exterior scan is a stage of its own, once per CTA), in
SM cycles and in us per column step (cycle shares of the measured step);
`[batches]` lines with the three committed kernels on each of the main
path's four batches (db 16 x 6,145 and 8 x 5,121; ris 64 x 1,281 and 64 x
1,025) and their sums, launches x (time - bound); and one JSON object
last.

--kernel grids (csrc/access_grids.cu, the weight grids' two launches):
each build at each of its (threads, tile) runs, the parent at
--parent-threads with a thread per cell; the committed build at every
--threads with every --tile (columns per CTA of the outside launch; the
inside launch runs a thread per cell). Every build must give the planes
of make_grids and make_outside_grids bit for bit (the seed within 2
ulps) on the first db and ris batches. Prints `[ab]` lines (ms in turns
through `_grids_call`, the launch alone by torch.profiler, x its byte
bound), `[split]` lines (the wrapper's host microseconds per call by
part, `chip_smoke.grids_wrapper_split`), `[batches]` lines (both wrappers
as the main path calls them on all four batches, and launches x (time -
bound)), then JSON.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC_REL = "priblast_tpu_torch/csrc/access_{}.cu"
PLANE_RTOL, ENERGY_TOL = 1e-4, 2e-3


def main_path_batches(seed: int):
    """The accessibility batches of the main path on chip_smoke.py's
    workload from `seed`: (db batches, ris batches), each a list of
    (codes [B, n_max] uint8, lengths [B] int64)."""
    import numpy as np

    import chip_smoke as cs
    from priblast_tpu_torch.models import db_gpu
    from priblast_tpu_torch.ops import native
    from priblast_tpu_torch.utils import alphabet

    rng = np.random.default_rng(seed)
    db_lens = cs.DB_LEN + rng.integers(-cs.DB_LEN // 25, cs.DB_LEN // 25 + 1,
                                       cs.N_DB)
    q_lens = cs.Q_LEN + rng.integers(-cs.Q_LEN // 25, cs.Q_LEN // 25 + 1,
                                     cs.N_Q)
    db_seqs = cs.markov_batch(rng, db_lens)
    q_seqs = cs.markov_batch(rng, q_lens)
    wave = [int(i) for i in native.argsort_desc(q_lens)]

    def plan(seqs, idxs):
        out = []
        for group, bsz, padded in db_gpu.plan_batches(
                [len(seqs[i]) for i in idxs]):
            codes = np.zeros((bsz, padded), np.uint8)
            lens = np.zeros(bsz, np.int64)
            for bi, g in enumerate(group):
                codes[bi, : len(seqs[idxs[g]])] = alphabet.access_codes(
                    seqs[idxs[g]])
                lens[bi] = len(seqs[idxs[g]])
            out.append((codes, lens))
        return out

    return plan(db_seqs, list(range(len(db_seqs)))), plan(q_seqs, wave)


def grids_ab(args, card: str, out_dir: Path) -> int:
    """--kernel grids: the grid kernel's two launches (inside_kernel,
    outside_kernel of csrc/access_grids.cu) in the parent's, the committed
    and each variant's build, held bit for bit to make_grids and
    make_outside_grids (the seed within chip_smoke.SEED_ULPS ulps) on the
    first db and ris batches, timed in turns through `_grids_call` (the
    wrapper less its checks) and alone (torch.profiler); the wrapper's
    host time by part (`chip_smoke.grids_wrapper_split`); then both
    wrappers, as the main path calls them, on all four batches."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from priblast_tpu_torch.accessibility import batched
    from priblast_tpu_torch.ops import access_grids as ag
    from priblast_tpu_torch.ops import access_scan as acs
    from priblast_tpu_torch.ops import nvcc

    threads = [int(x) for x in (args.threads or str(ag.THREADS)).split(",")]
    tiles = [int(x) for x in (args.tile or str(ag.TILE)).split(",")]
    parent = Path(args.parent) if args.parent else out_dir / "parent_grids.cu"
    if not args.parent:
        parent.write_text(subprocess.run(
            ["git", "show", f"HEAD:{SRC_REL.format('grids')}"], cwd=HERE,
            check=True, capture_output=True, text=True).stdout)
    specs = {"parent": parent, "committed": ag.SRC}
    # (threads, tile) of each run; the parent's tile 0 is its own default
    runs = [("parent", args.parent_threads, 0)]
    runs += [("committed", nt, q) for nt in threads for q in tiles]
    for v in args.variants:
        name, _, spec = v.partition("=")
        src, _, nt = spec.partition("@")
        specs[name] = Path(src)
        runs.append((name, int(nt) if nt else threads[0], tiles[0]))

    regs = {}

    def build(name, src):
        flags = acs.NVCC_FLAGS
        try:
            lib = ctypes.CDLL(str(nvcc.build(src, flags)))
        except RuntimeError as e:
            print(f"access_ab: {name} does not build: {e}", file=sys.stderr)
            return name, None
        r = subprocess.run(
            [nvcc.shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc", *flags,
             "-Xptxas", "-v", "-o", str(out_dir / f"grids_{name}.so"),
             str(src)], capture_output=True, text=True)
        for part in r.stderr.split("Compiling entry function")[1:]:
            head = part.split("\n")[0]
            for kname in ("inside_kernel", "outside_kernel"):
                for dt in ("IfE", "IdE"):
                    if kname + dt in head:
                        regs[f"{name} {kname} {dt[1]}"] = " ".join(
                            ln.split(":", 1)[-1].strip()
                            for ln in part.splitlines()
                            if "registers" in ln or "spill" in ln)
        for side in ("inside", "outside"):
            for dt in ("f32", "f64"):
                fn = getattr(lib, f"access_grids_{side}_{dt}")
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p] * 4
        return name, lib

    with cf.ThreadPoolExecutor(len(specs) + 1) as ex:
        futs = [ex.submit(build, n, s) for n, s in specs.items()]
        wrap = ex.submit(ag._lib)
        scan = ex.submit(acs._lib, "inside")
        wrap.result()
        scan.result()
        libs = dict(f.result() for f in futs)
    bad = {n for n, lib in libs.items() if lib is None}
    print(f"[build] {', '.join(n for n in libs if n not in bad)} ({card})",
          flush=True)
    for key, r in regs.items():
        print(f"[build] {key}: {r}", flush=True)

    db_batches, ris_batches = main_path_batches(args.seed)
    dev, dt, w = torch.device("cuda"), torch.float32, 70
    band = w + 2
    stream = torch.cuda.current_stream().cuda_stream
    report = {"card": card, "kernel": "grids", "registers": regs,
              "batches": {}}

    def inputs(codes, lengths):
        """gargs = (t, s, lens, n_max, band, dtype) of one batch on the
        card, and oin = (g, multi2, A, B, logZ): the plain inside grids and
        the inside scan's outputs."""
        B, n_max = codes.shape
        s_np = np.zeros((B, n_max + batched.ML + 4), np.int64)
        s_np[:, 1: n_max + 1] = codes
        s = torch.as_tensor(s_np, device=dev)
        lens = torch.as_tensor(lengths, device=dev)
        t = batched.make_tables(w, dt, dev)
        gargs = (t, s, lens, n_max, band, dt)
        g = batched.make_grids(*gargs)
        ins = acs.inside_scan(t, g, lens, n_max, band, dt)
        return gargs, (g, ins[5], ins[6], ins[7],
                       ins[6].gather(0, lens[None, :])[0])

    for bname, (codes, lengths) in (("db", db_batches[0]),
                                    ("ris", ris_batches[0])):
        B, n_max = codes.shape
        n1 = n_max + 1
        with torch.no_grad():
            gargs, oin = inputs(codes, lengths)
            t, s, lens = gargs[:3]
            g = oin[0]
            og = batched.make_outside_grids(*gargs, *oin)
            outside = (g, oin[2], oin[3], oin[4], oin[1])
            rec = report["batches"][bname] = {"B": B, "columns": n1}
            for side, ref in (("inside", g), ("outside", og)):
                def call(name, nt, q, side=side):
                    return ag._grids_call(
                        getattr(libs[name], f"access_grids_{side}_f32"), s,
                        lens, n_max, band, dt, stream,
                        None if side == "inside" else outside, threads=nt,
                        tile=q)

                good = []
                # the inside launch has no tile: a thread per cell
                side_runs = list(dict.fromkeys(
                    (name, nt, q if side == "outside" else 0)
                    for name, nt, q in runs))
                for name, nt, q in side_runs:
                    if name in bad:
                        continue
                    try:
                        out = call(name, nt, q)
                        torch.cuda.synchronize()
                    except RuntimeError as e:
                        print(f"[check] {bname} {side} {name} threads={nt} "
                              f"tile={q}: {e}", flush=True)
                        continue
                    differ, ulps, _ = cs.grids_diff(out, ref)
                    print(f"[check] {bname} {side} {name} threads={nt} "
                          f"tile={q}: planes that differ {differ}, seed "
                          f"{ulps} ulps", flush=True)
                    if differ or ulps > cs.SEED_ULPS:
                        print(f"access_ab: {name} differs from the plain "
                              f"version on the {bname} batch",
                              file=sys.stderr)
                        bad.add(name)
                    else:
                        good.append((name, nt, q))
                bound, bound_by = cs.grids_bound_ms(B, n1, band, s.shape[1],
                                                    4, side == "inside")
                times, alone = {}, {}
                for turn in (good, good[::-1]):
                    for name, nt, q in turn:
                        key = f"{name}@{nt}x{q}"
                        ms = cs.cuda_ms(lambda: call(name, nt, q), args.reps)
                        times.setdefault(key, []).append(ms)
                for name, nt, q in good:
                    key = f"{name}@{nt}x{q}"
                    by = cs.device_ms_by_kernel(lambda: call(name, nt, q),
                                                (f"{side}_kernel",))
                    alone[key] = by.get(f"{side}_kernel")
                    a = alone[key]
                    print(f"[ab] {bname} B={B} columns={n1} {side} {key}: "
                          + " / ".join(f"{x:.4f}" for x in times[key])
                          + " ms in turns, the launch alone "
                          + (f"{a:.4f} ms ({a / bound:.2f}x bound)" if a
                             else "not measured")
                          + f"; bound {bound:.6f} ms ({bound_by}) ({card})",
                          flush=True)
                split = cs.grids_wrapper_split(
                    ag, side, gargs, None if side == "inside" else oin)
                print(f"[split] {bname} {side} wrapper, host us per call: "
                      + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
                      + f" ({card})", flush=True)
                rec[side] = dict(bound_ms=bound, bound_by=bound_by,
                                 times_ms=times, alone_ms=alone,
                                 wrapper_us=split)

    # both wrappers, as the main path calls them, on all four batches
    sums = {k: dict(ms=0.0, bound_ms=0.0, launches=0)
            for k in ("inside", "outside")}
    report["main_path"] = []
    for bname, blist in (("db", db_batches), ("ris", ris_batches)):
        for k, (codes, lengths) in enumerate(blist):
            B, n_max = codes.shape
            n1 = n_max + 1
            with torch.no_grad():
                gargs, oin = inputs(codes, lengths)
                for side, fn, a in (("inside", ag.inside_grids, gargs),
                                    ("outside", ag.outside_grids,
                                     (*gargs, *oin))):
                    ms = cs.cuda_ms(lambda: fn(*a, checked=True), args.reps)
                    bound, bound_by = cs.grids_bound_ms(
                        B, n1, band, gargs[1].shape[1], 4, side == "inside")
                    sums[side]["ms"] += ms
                    sums[side]["bound_ms"] += bound
                    sums[side]["launches"] += 1
                    report["main_path"].append(dict(
                        kernel=side, batch=f"{bname}{k + 1}", B=B,
                        columns=n1, ms=ms, bound_ms=bound))
                    print(f"[batches] {side}_grids {bname} batch {k + 1} "
                          f"B={B} columns={n1}: {ms:.4f} ms through the "
                          f"wrapper, bound {bound:.6f} ms ({bound_by}), "
                          f"{ms / bound:.2f}x ({card})", flush=True)
    for side, v in sums.items():
        v["loss_ms"] = v["ms"] - v["bound_ms"]
        print(f"[batches] {side}_grids over {v['launches']} launches: "
              f"{v['ms']:.4f} ms, bound {v['bound_ms']:.6f} ms, launches x "
              f"(time - bound) {v['loss_ms']:.4f} ms ({card})", flush=True)
    report["main_path_sums"] = sums
    report["at"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    report["differ"] = sorted(bad)
    print(json.dumps(report))
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", metavar="NAME=SRC[@THREADS]")
    ap.add_argument("--kernel", choices=("outside", "inside", "prob",
                                          "grids"), default="outside")
    ap.add_argument("--parent", help="the parent's access_<kernel>.cu")
    ap.add_argument("--parent-threads", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--threads",
                    help="threads per CTA of the committed build, "
                         "comma-separated (default: the wrapper's); the "
                         "first is every variant's default")
    ap.add_argument("--tile",
                    help="columns per CTA of every build but the parent's "
                         "(default: the wrapper's); grids: comma-separated, "
                         "the committed build at each, with each --threads")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("access_ab: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from priblast_tpu_torch.accessibility import batched
    from priblast_tpu_torch.ops import access_prob as aprob
    from priblast_tpu_torch.ops import access_scan as acs
    from priblast_tpu_torch.ops import native, nvcc

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out_dir = HERE / "build" / "access_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    kern = args.kernel
    if kern == "grids":
        return grids_ab(args, card, out_dir)
    prob_tile = int(args.tile) if args.tile else None
    inside, prob = kern == "inside", kern == "prob"
    threads = [int(x) for x in (args.threads or str(
        aprob.THREADS if prob else acs.THREADS if inside
        else acs.OUTSIDE_THREADS)).split(",")]

    parent = (Path(args.parent) if args.parent
              else out_dir / f"parent_{kern}.cu")
    if not args.parent:
        parent.write_text(subprocess.run(
            ["git", "show", f"HEAD:{SRC_REL.format(kern)}"], cwd=HERE,
            check=True, capture_output=True, text=True).stdout)
    specs = {"parent": parent,
             "committed": aprob.SRC if prob else acs.SRC_INSIDE if inside
             else acs.SRC_OUTSIDE}
    own = {"parent": args.parent_threads, "committed": threads[0]}
    for v in args.variants:
        name, _, spec = v.partition("=")
        src, _, nt = spec.partition("@")
        specs[name] = Path(src)
        own[name] = int(nt) if nt else threads[0]
    builds = {n: (s, False) for n, s in specs.items()}
    builds.update((f"{n}+stamps", (s, True)) for n, s in specs.items()
                  if "ACCESS_STAMPS" in s.read_text())
    own.update((f"{n}+stamps", own[n]) for n in specs)

    def build(name, src, stamped):
        flags = acs.NVCC_FLAGS + (["-DACCESS_STAMPS"] if stamped else [])
        try:
            lib = ctypes.CDLL(str(nvcc.build(src, flags)))
        except RuntimeError as e:
            print(f"access_ab: {name} does not build: {e}", file=sys.stderr)
            return name, None
        if not stamped:   # registers and spills of the float kernel
            r = subprocess.run(
                [nvcc.shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc",
                 *flags, "-Xptxas", "-v", "-o", str(out_dir / f"{name}.so"),
                 str(src)], capture_output=True, text=True)
            # the float kernel (prob: the window kernel, rows staged)
            key = "window_kernelIfLb1E" if prob else "IfE"
            for part in r.stderr.split("Compiling entry function")[1:]:
                if key in part.split("\n")[0]:
                    regs[name] = " ".join(
                        ln.split(":", 1)[-1].strip()
                        for ln in part.splitlines()
                        if "registers" in ln or "spill" in ln)
        for fn in (f"access_{kern}_f32", f"access_{kern}_f64"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [ctypes.c_void_p] * 4
        if stamped:
            getattr(lib, f"access_{kern}_stamps").restype = ctypes.c_int
            getattr(lib, f"access_{kern}_stamps").argtypes = [
                ctypes.c_void_p]
            getattr(lib, f"access_{kern}_stage_names").restype = (
                ctypes.c_char_p)
        return name, lib

    regs = {}
    with cf.ThreadPoolExecutor(len(builds) + 3) as ex:
        futs = [ex.submit(build, n, s, st) for n, (s, st) in builds.items()]
        wrappers = [ex.submit(acs._lib, k) for k in ("inside", "outside")]
        ex.submit(native.build).result()
        for f in wrappers:
            f.result()
        libs = dict(f.result() for f in futs)
    failed = sorted(n for n, lib in libs.items() if lib is None)
    libs = {n: lib for n, lib in libs.items() if lib is not None}
    print(f"[build] {', '.join(libs)} ({card})", flush=True)
    for name, r in regs.items():
        print(f"[build] {name} float: {r}", flush=True)

    db_batches, ris_batches = main_path_batches(args.seed)
    batches = {"db": db_batches[0], "ris": ris_batches[0]}
    dev, dt, w, dmin = torch.device("cuda"), torch.float32, 70, 5
    band = w + 2
    kT = batched._linmodel(w).sp.kT
    stream = torch.cuda.current_stream().cuda_stream
    report = {"card": card, "threads": own, "registers": regs,
              "batches": {}}
    kernel_names = ("window_kernel", "sum_kernel")
    bad = set(failed)  # builds that fail or differ from the plain version
    no_launch = set()  # (build, threads) refused at launch

    def inputs(codes, lengths):
        """The tables, grids and sequences of one batch on the card."""
        B, n_max = codes.shape
        s_np = np.zeros((B, n_max + batched.ML + 4), np.int64)
        s_np[:, 1: n_max + 1] = codes
        s = torch.as_tensor(s_np, device=dev)
        lens = torch.as_tensor(lengths, device=dev)
        t = batched.make_tables(w, dt, dev)
        g = batched.make_grids(t, s, lens, n_max, band, dt)
        return t, g, s, lens, n_max

    for bname, (codes, lengths) in batches.items():
        B, n_max = codes.shape
        n1 = n_max + 1
        with torch.no_grad():
            t, g, s, lens, n_max = inputs(codes, lengths)

            def energies(ins, outs):
                pw = batched.scan_probabilities(t, g, s, lens, dmin, n_max,
                                                band, dt, ins, outs)
                return batched.accessibility_from_probabilities(
                    *pw, lens, dmin, n_max, kT)

            def plain_outside(ins):
                og, m1 = batched.outside_inputs(t, s, lens, n_max, band, dt,
                                                g, ins)
                return acs.outside_plain(t, og, m1, n_max, band, dt)

            if inside:
                ref = acs.inside_plain(t, g, lens, n_max, band, dt)
                e_ref = energies(ref, plain_outside(ref))

                def call(name, nt):
                    return acs._inside_call(
                        libs[name].access_inside_f32, t, g, lens, n_max,
                        band, dt, stream, nt)

                def run_energies(out):
                    return energies(out, plain_outside(out))
            elif prob:
                ins = acs.inside_scan(t, g, lens, n_max, band, dt)
                og, m1 = batched.outside_inputs(t, s, lens, n_max, band, dt,
                                                g, ins)
                outs = acs.outside_scan(t, og, m1, n_max, band, dt)
                ref = batched.scan_probabilities(t, g, s, lens, dmin, n_max,
                                                 band, dt, ins, outs)

                def run_energies(out):
                    return batched.accessibility_from_probabilities(
                        *out, lens, dmin, n_max, kT)

                e_ref = run_energies(ref)

                def call(name, nt):
                    return aprob._prob_call(
                        libs[name].access_prob_f32, g, s, lens, dmin, n_max,
                        band, dt, ins, outs, stream, nt,
                        None if name == "parent" else prob_tile)
            else:
                ins = acs.inside_scan(t, g, lens, n_max, band, dt)
                og, m1 = batched.outside_inputs(t, s, lens, n_max, band, dt,
                                                g, ins)
                ref = acs.outside_plain(t, og, m1, n_max, band, dt)
                e_ref = energies(ins, ref)

                def call(name, nt):
                    return acs._outside_call(
                        libs[name].access_outside_f32, t, og, m1, n_max,
                        band, dt, stream, nt)

                def run_energies(out):
                    return energies(ins, out)

            runs = [(n, own[n]) for n in libs]
            runs += [("committed", nt) for nt in threads[1:]
                     if "committed" in libs]
            for name, nt in runs:
                if name in bad:
                    continue
                try:
                    out = call(name, nt)
                except RuntimeError as e:  # too many registers for nt
                    print(f"[check] {bname} {name} threads={nt}: {e}",
                          flush=True)
                    no_launch.add((name, nt))
                    if nt == own[name] and not name.endswith("+stamps"):
                        bad.add(name)
                    continue
                torch.cuda.synchronize()
                floor = torch.finfo(dt).tiny / PLANE_RTOL
                rel = max(float(((a.double() - r.double()).abs()
                                 / (r.double().abs() + floor)).max())
                          for a, r in zip(out, ref))
                de = max(float((x - y).abs().max())
                         for x, y in zip(run_energies(out), e_ref))
                print(f"[check] {bname} {name} threads={nt}: max rel "
                      f"plane diff {rel:.3g}, max |energy diff| "
                      f"{de:.3g} kcal/mol", flush=True)
                if not (rel <= PLANE_RTOL and de <= ENERGY_TOL):
                    print(f"access_ab: {name} differs from the plain "
                          f"version on the {bname} batch",
                          file=sys.stderr)
                    bad.add(name)

            bound, bound_by = (cs.prob_bound_ms(B, n1, band, dmin, 4)
                               if prob else
                               cs.access_bound_ms(B, n1, band, 4, inside))
            times = {}
            runs = [(n, nt) for n, nt in runs
                    if n not in bad and (n, nt) not in no_launch]
            for turn in (runs, runs[::-1]):
                for name, nt in turn:
                    key = name if nt == own[name] else f"{name}@{nt}"
                    ms = cs.cuda_ms(lambda: call(name, nt), args.reps)
                    times.setdefault(key, []).append(ms)
                    print(f"[ab] {bname} B={B} columns={n1} {key}: "
                          f"{ms:.4f} ms, {1e3 * ms / n1:.4f} us per column "
                          f"step, {ms / bound:.1f}x bound ({card})",
                          flush=True)

            splits = {}
            for name, nt in runs if prob else ():
                key = name if nt == own[name] else f"{name}@{nt}"
                by = cs.device_ms_by_kernel(lambda: call(name, nt),
                                            kernel_names)
                splits[key] = by
                print(f"[launches] {bname} {key}: " + (", ".join(
                    f"{k} {by[k]:.4f} ms" for k in kernel_names if k in by)
                    or "not measured (no device time seen)")
                    + f" ({card})", flush=True)
            for name, lib in libs.items():
                if (not name.endswith("+stamps") or name in bad
                        or (name, own[name]) in no_launch):
                    continue
                sums = (ctypes.c_ulonglong * 64)()
                ptr = ctypes.cast(sums, ctypes.c_void_p)
                stamps = getattr(lib, f"access_{kern}_stamps")
                stamps(ptr)                           # clear
                call(name, own[name])
                torch.cuda.synchronize()
                stamps(ptr)
                stages = getattr(lib, f"access_{kern}_stage_names")(
                    ).decode().split(",")
                k = len(stages)
                cols = sums[2 * k]
                total = sum(sums[: 2 * k])
                us_step = 1e3 * min(times[name]) / n1
                split = {}
                for i, st in enumerate(stages):
                    for part, v in (("work", sums[i]),
                                    ("barrier", sums[k + i])):
                        split[f"{st}.{part}"] = dict(
                            cycles=v / cols, us=us_step * v / total)
                splits[name] = split
                print(f"[split] {bname} {name}: " + ", ".join(
                    f"{key} {v['cycles']:.0f} cyc {v['us']:.3f} us"
                    for key, v in split.items())
                    + f" per column step ({card})", flush=True)
        report["batches"][bname] = dict(
            B=B, columns=n1, bound_ms=bound, bound_by=bound_by,
            times_ms=times, splits=splits)

    # the three committed kernels, through their wrappers, on all four
    # batches
    sums = {k: dict(ms=0.0, bound_ms=0.0, launches=0)
            for k in ("inside", "outside", "prob")}
    report["main_path"] = []
    for bname, blist in (("db", db_batches), ("ris", ris_batches)):
        for k, (codes, lengths) in enumerate(blist):
            B, n_max = codes.shape
            n1 = n_max + 1
            with torch.no_grad():
                t, g, s, lens, n_max = inputs(codes, lengths)
                iargs = (t, g, lens, n_max, band, dt)
                ins = acs.inside_scan(*iargs)
                og, m1 = batched.outside_inputs(t, s, lens, n_max, band, dt,
                                                g, ins)
                oargs = (t, og, m1, n_max, band, dt)
                outs = acs.outside_scan(*oargs)
                pargs = (t, g, s, lens, dmin, n_max, band, dt, ins, outs)
                for kname, fn, args_ in (("inside", acs.inside_scan, iargs),
                                         ("outside", acs.outside_scan,
                                          oargs),
                                         ("prob", aprob.window_probs,
                                          pargs)):
                    ms = cs.cuda_ms(lambda: fn(*args_), args.reps)
                    bound, bound_by = (
                        cs.prob_bound_ms(B, n1, band, dmin, 4)
                        if kname == "prob" else cs.access_bound_ms(
                            B, n1, band, 4, kname == "inside"))
                    sums[kname]["ms"] += ms
                    sums[kname]["bound_ms"] += bound
                    sums[kname]["launches"] += 1
                    report["main_path"].append(dict(
                        kernel=kname, batch=f"{bname}{k + 1}", B=B,
                        columns=n1, ms=ms, bound_ms=bound, bound_by=bound_by))
                    print(f"[batches] access_{kname} {bname} batch {k + 1} "
                          f"B={B} columns={n1}: {ms:.4f} ms, "
                          f"{1e3 * ms / n1:.4f} us per column step, bound "
                          f"{bound:.6f} ms ({bound_by}), {ms / bound:.1f}x "
                          f"({card})", flush=True)
    for kname, v in sums.items():
        v["loss_ms"] = v["ms"] - v["bound_ms"]
        print(f"[batches] access_{kname} over {v['launches']} launches: "
              f"{v['ms']:.4f} ms, bound {v['bound_ms']:.6f} ms, "
              f"launches x (time - bound) {v['loss_ms']:.4f} ms ({card})",
              flush=True)
    report["main_path_sums"] = sums
    report["kernel"] = kern
    report["at"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    report["differ"] = sorted(bad)
    print(json.dumps(report))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
