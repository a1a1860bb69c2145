#!/usr/bin/env python3
"""The outside column-scan kernel against its parent version and variants,
on one GPU, on the main path's first db batch and first ris batch.

    python3 access_ab.py [--parent FILE] [--parent-threads 256] [--reps 5]
                         [--threads 768,512] [NAME=SRC[@THREADS] ...]

Builds, with the wrapper's nvcc flags: the parent's
priblast_tpu_torch/csrc/access_outside.cu (--parent, else `git show
HEAD:` of it), the committed one, each NAME=SRC variant (a source with the
same C interface), and a stamped build (-DACCESS_STAMPS) of every source
that has the stamp hooks. Each build runs at its own threads per CTA: the
parent at --parent-threads (what its wrapper launched), a variant at
@THREADS, else the first --threads (default: the wrapper's); the
committed one also at the other --threads. The batches are those of
`chip_smoke.py`'s workload from --seed (its first `db` batch, 16 x 6,145
columns, and the first `ris` batch, 64 x 1,281), with the outside inputs
made from the inside kernel's planes, as on the main path. Every build
must give the plain version's planes (`outside_pass`) within 1e-4
relative in float32 and window energies within 2e-3 kcal/mol; then all
are timed with CUDA events in turns (first to last, then last to first).

Prints per build and batch: ms, us per column step, x its bound; per
stamped build the stage split (work: from the previous barrier to the
last thread's arrival; barrier: from there to thread 0's exit), in SM
cycles and in us per column step (cycle shares of the measured step);
and one JSON object last.
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
SRC_REL = "priblast_tpu_torch/csrc/access_outside.cu"
PLANE_RTOL, ENERGY_TOL = 1e-4, 2e-3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", metavar="NAME=SRC[@THREADS]")
    ap.add_argument("--parent", help="the parent's access_outside.cu")
    ap.add_argument("--parent-threads", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--threads",
                    help="threads per CTA of the committed build, "
                         "comma-separated (default: the wrapper's); the "
                         "first is every variant's default")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("access_ab: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from priblast_tpu_torch.accessibility import batched
    from priblast_tpu_torch.models import db_gpu
    from priblast_tpu_torch.ops import access_scan as acs
    from priblast_tpu_torch.ops import native, nvcc
    from priblast_tpu_torch.utils import alphabet

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out_dir = HERE / "build" / "access_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    threads = [int(x) for x in (args.threads
                                or str(acs.OUTSIDE_THREADS)).split(",")]

    parent = Path(args.parent) if args.parent else out_dir / "parent.cu"
    if not args.parent:
        parent.write_text(subprocess.run(
            ["git", "show", f"HEAD:{SRC_REL}"], cwd=HERE, check=True,
            capture_output=True, text=True).stdout)
    specs = {"parent": parent, "committed": acs.SRC_OUTSIDE}
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
            for part in r.stderr.split("Compiling entry function")[1:]:
                if "IfE" in part.split("\n")[0]:
                    regs[name] = " ".join(
                        ln.split(":", 1)[-1].strip()
                        for ln in part.splitlines()
                        if "registers" in ln or "spill" in ln)
        for fn in ("access_outside_f32", "access_outside_f64"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [ctypes.c_void_p] * 4
        if stamped:
            lib.access_outside_stamps.restype = ctypes.c_int
            lib.access_outside_stamps.argtypes = [ctypes.c_void_p]
            lib.access_outside_stage_names.restype = ctypes.c_char_p
        return name, lib

    regs = {}
    with cf.ThreadPoolExecutor(len(builds) + 2) as ex:
        futs = [ex.submit(build, n, s, st) for n, (s, st) in builds.items()]
        futs.append(ex.submit(lambda: ("inside", acs._lib("inside"))))
        ex.submit(native.build).result()
        libs = dict(f.result() for f in futs)
    libs.pop("inside")
    failed = sorted(n for n, lib in libs.items() if lib is None)
    libs = {n: lib for n, lib in libs.items() if lib is not None}
    print(f"[build] {', '.join(libs)} ({card})", flush=True)
    for name, r in regs.items():
        print(f"[build] {name} float: {r}", flush=True)

    # the workload of chip_smoke.py, and its first db and ris batches
    rng = np.random.default_rng(args.seed)
    db_lens = cs.DB_LEN + rng.integers(-cs.DB_LEN // 25, cs.DB_LEN // 25 + 1,
                                       cs.N_DB)
    q_lens = cs.Q_LEN + rng.integers(-cs.Q_LEN // 25, cs.Q_LEN // 25 + 1,
                                     cs.N_Q)
    db_seqs = cs.markov_batch(rng, db_lens)
    q_seqs = cs.markov_batch(rng, q_lens)
    wave = [int(i) for i in native.argsort_desc(q_lens)]

    def first_batch(seqs, idxs):
        group, bsz, padded = next(db_gpu.plan_batches(
            [len(seqs[i]) for i in idxs]))
        codes = np.zeros((bsz, padded), np.uint8)
        lens = np.zeros(bsz, np.int64)
        for bi, g in enumerate(group):
            codes[bi, : len(seqs[idxs[g]])] = alphabet.access_codes(
                seqs[idxs[g]])
            lens[bi] = len(seqs[idxs[g]])
        return codes, lens

    batches = {"db": first_batch(db_seqs, list(range(len(db_seqs)))),
               "ris": first_batch(q_seqs, wave)}
    dev, dt, w, dmin = torch.device("cuda"), torch.float32, 70, 5
    band = w + 2
    kT = batched._linmodel(w).sp.kT
    stream = torch.cuda.current_stream().cuda_stream
    report = {"card": card, "threads": own, "registers": regs,
              "batches": {}}
    bad = set(failed)  # builds that fail or differ from the plain version
    no_launch = set()  # (build, threads) refused at launch

    for bname, (codes, lengths) in batches.items():
        B, n_max = codes.shape
        n1 = n_max + 1
        s_np = np.zeros((B, n_max + batched.ML + 4), np.int64)
        s_np[:, 1: n_max + 1] = codes
        s = torch.as_tensor(s_np, device=dev)
        lens = torch.as_tensor(lengths, device=dev)
        with torch.no_grad():
            t = batched.make_tables(w, dt, dev)
            g = batched.make_grids(t, s, lens, n_max, band, dt)
            ins = acs.inside_scan(t, g, lens, n_max, band, dt)
            og, m1 = batched.outside_inputs(t, s, lens, n_max, band, dt, g,
                                            ins)
            ref = acs.outside_plain(t, og, m1, n_max, band, dt)

            def energies(outs):
                pw = batched.scan_probabilities(t, g, s, lens, dmin, n_max,
                                                band, dt, ins, outs)
                return batched.accessibility_from_probabilities(
                    *pw, lens, dmin, n_max, kT)

            e_ref = energies(ref)

            def call(name, nt):
                return acs._outside_call(
                    libs[name].access_outside_f32, t, og, m1, n_max, band,
                    dt, stream, nt)

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
                         for x, y in zip(energies(out), e_ref))
                print(f"[check] {bname} {name} threads={nt}: max rel "
                      f"plane diff {rel:.3g}, max |energy diff| "
                      f"{de:.3g} kcal/mol", flush=True)
                if not (rel <= PLANE_RTOL and de <= ENERGY_TOL):
                    print(f"access_ab: {name} differs from the plain "
                          f"version on the {bname} batch",
                          file=sys.stderr)
                    bad.add(name)

            bound, bound_by = cs.access_bound_ms(B, n1, band, 4, False)
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
            for name, lib in libs.items():
                if (not name.endswith("+stamps") or name in bad
                        or (name, own[name]) in no_launch):
                    continue
                sums = (ctypes.c_ulonglong * 64)()
                ptr = ctypes.cast(sums, ctypes.c_void_p)
                lib.access_outside_stamps(ptr)        # clear
                call(name, own[name])
                torch.cuda.synchronize()
                lib.access_outside_stamps(ptr)
                stages = lib.access_outside_stage_names().decode().split(",")
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
    report["at"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    report["differ"] = sorted(bad)
    print(json.dumps(report))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
