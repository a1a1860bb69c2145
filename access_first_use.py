#!/usr/bin/env python3
"""Where the first use of the accessibility path goes in a fresh process on
one GPU: the accessibility batches of `ris --engine gpu` (or, with --db, of
`db --engine gpu`), split into their parts, timed once cold and once warm.

    python3 access_first_use.py [--db] [--work build/chip_smoke] [--runs 2]

Each run is a fresh process (`--child`) that reads chip_smoke.py's
workload from --work (q.fa, or db.fa with --db; written there from seed 0
where missing), makes the CUDA context, and then goes twice over every
batch that `ris` (or `db`) plans for those sequences (`plan_batches`), as
`BatchedRaccess.run` does, synchronising after each part:
- h2d: the host-to-device copy;
- load_grids, grids: the grid kernel's library (build check and dlopen,
  `ops/access_grids.py:_lib`), then the tables and the inside grids'
  launch (`inside_grids`);
- load_inside, inside: the inside scan kernel's library
  (`ops/access_scan.py:_lib`), then its call; likewise outside_grids
  (the grid kernel's outside launch, through `outside_inputs`),
  load_outside and outside;
- load_prob: the probability kernel's library (`ops/access_prob.py:_lib`);
- energies: the probability kernel's call whose sum launch writes the
  window energies (`window_energies`, as `BatchedRaccess._run_rows` ends
  in it) and the one copy back.
The first pass holds every first use (libraries, the kernels' modules and
shared-memory attributes, PyTorch's first launches and allocations); the
second holds none. The kernels' libraries must be built already
(chip_smoke.py builds them).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parent
PARTS = ("h2d", "load_grids", "grids", "load_inside", "inside",
         "outside_grids", "load_outside", "outside", "load_prob",
         "energies")


def child(work: Path, fa: str) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    from priblast_tpu_torch.accessibility import batched as ab
    from priblast_tpu_torch.models import db_gpu
    from priblast_tpu_torch.ops import access_grids, access_prob
    from priblast_tpu_torch.ops import access_scan as acs
    from priblast_tpu_torch.utils import alphabet, fasta
    from priblast_tpu_torch.utils.params import DbParams

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    print(f"[first-use] context {time.perf_counter() - t0:.4f} s", flush=True)

    p = DbParams()  # the db that `ris` reads carries these w and d
    w, dmin, dt = p.maximal_span, p.min_accessible_length, torch.float32
    band = w + 2
    kT = float(ab._linmodel(w).sp.kT)
    _names, seqs = fasta.read_fasta(work / fa)
    lengths = [len(s) for s in seqs]
    batches = []
    limits = db_gpu.batch_limits([dev], band, dt)
    for group, bsz, padded in db_gpu.plan_batches(lengths, limits):
        codes = np.zeros((bsz, padded + ab.ML + 4), np.int64)
        for bi, idx in enumerate(group):
            codes[bi, 1: lengths[idx] + 1] = alphabet.access_codes(seqs[idx])
        lens = np.zeros(bsz, np.int64)
        lens[: len(group)] = [lengths[i] for i in group]
        batches.append((codes, lens, padded))
    shapes = ", ".join(f"{c.shape[0]} x {n}" for c, _l, n in batches)

    for name in ("cold", "warm"):
        parts: dict[str, float] = defaultdict(float)

        def part(key, fn):
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            parts[key] += time.perf_counter() - t
            return out

        for codes, lens_np, n_max in batches:
            s, lens = part("h2d", lambda: (torch.as_tensor(codes, device=dev),
                                           torch.as_tensor(lens_np,
                                                           device=dev)))
            with torch.no_grad():
                part("load_grids", access_grids._lib)
                t, g = part("grids", lambda: (
                    tb := ab.make_tables(w, dt, dev),
                    access_grids.inside_grids(tb, s, lens, n_max, band, dt,
                                              checked=True)))
                part("load_inside", lambda: acs._lib("inside"))
                ins = part("inside", lambda: acs.inside_scan(
                    t, g, lens, n_max, band, dt, checked=True))
                og, m1 = part("outside_grids", lambda: ab.outside_inputs(
                    t, s, lens, n_max, band, dt, g, ins, checked=True))
                part("load_outside", lambda: acs._lib("outside"))
                outs = part("outside", lambda: acs.outside_scan(
                    t, og, m1, n_max, band, dt))
                part("load_prob", access_prob._lib)

                def energies():
                    out = access_prob.window_energies(
                        t, g, s, lens, dmin, n_max, band, dt, ins, outs, kT,
                        checked=True)
                    return out.cpu().numpy()

                part("energies", energies)
        print(f"[first-use] {name} {fa} {len(batches)} batches ({shapes}) "
              f"{sum(parts.values()):.4f} s: "
              + " ".join(f"{k} {parts[k]:.4f}" for k in PARTS), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work", type=Path, default=REPO / "build" / "chip_smoke")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--db", action="store_true",
                    help="the db batches (db.fa) instead of the ris ones")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    work = args.work.resolve()
    fa = "db.fa" if args.db else "q.fa"
    if not (work / fa).is_file():
        sys.path.insert(0, str(REPO))
        import chip_smoke

        chip_smoke.write_workload(work, 0)
    if args.child:
        child(work, fa)
        return 0
    for _ in range(args.runs):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, __file__, "--child", "--work",
                            str(work), *(["--db"] if args.db else [])],
                           cwd=REPO)
        if r.returncode != 0:
            return r.returncode
        print(f"[first-use] process wall {time.perf_counter() - t0:.3f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
