#!/usr/bin/env python3
"""The port's `db` and `ris` (`--engine gpu`) from two checkouts, in turns,
on one GPU: wall seconds and stage seconds of each run.

    python3 stage_ab.py A_DIR [B_DIR] [--rounds 1] [--work build/chip_smoke]

B_DIR defaults to this checkout. Each run is `python3 -m
priblast_tpu_torch db` and then `ris`, in fresh processes started from the
checkout's root with PRIBLAST_TIMINGS=1 (synchronised stage timings), on
the workload chip_smoke.py writes (its db.fa and q.fa in --work: run
chip_smoke.py first). A round runs A, B, B, A. The wall seconds of a run
include the process start (interpreter, imports, CUDA context); the
stage seconds are the run's own report. Before the rounds, each checkout
runs `db` and `ris` once on the tiny test data, which builds its kernels
and native library, so no build falls in a timed run. Both sides must
write the same hits (query, target, lengths and base pairs); the count of
whole output lines (energies included) that differ between the two sides'
last runs and each side's body sha256 are printed beside that.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent


def run(root: Path, step: str, args: list[str]) -> tuple[float, dict]:
    """One `step` in a fresh process from `root`: (wall s, stage s)."""
    # ris on the device chain (the router's default, auto, may send
    # queries to the host chain; a parent without the router ignores it)
    env = dict(os.environ, PRIBLAST_TIMINGS="1", PRIBLAST_DEVICE_EXTEND="1")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "priblast_tpu_torch", step,
                        *args], cwd=root, env=env, capture_output=True,
                       text=True)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        sys.exit(f"stage_ab: {step} failed in {root}:\n{r.stderr[-3000:]}")
    stages = {m[1]: float(m[2]) for m in re.finditer(
        r"^\s+(\S+)\s+([0-9.]+)s\s+x\d+$", r.stdout + r.stderr, re.M)}
    return wall, stages


def hit_keys(path: Path) -> list[str]:
    """Output lines without the running id and the energies."""
    return sorted(",".join(f[1:5] + f[8:]) for f in (
        line.split(",") for line in path.read_text().splitlines()[3:]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path, nargs="?", default=REPO)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--work", type=Path, default=REPO / "build" / "chip_smoke")
    args = ap.parse_args()
    work = args.work.resolve()
    db_fa, q_fa = work / "db.fa", work / "q.fa"
    if not (db_fa.is_file() and q_fa.is_file()):
        sys.exit(f"stage_ab: no chip_smoke.py workload in {work}")
    db_nt = sum(len(line.strip()) for line in db_fa.read_text().splitlines()
                if not line.startswith(">"))
    n_q = sum(line.startswith(">") for line in q_fa.read_text().splitlines())
    sides = {"A": args.a.resolve(), "B": args.b.resolve()}
    data = REPO / "tests" / "data"
    for name, root in sides.items():
        warm = work / f"ab_warm_{name}"
        run(root, "db", ["-i", str(data / "tiny_db.fa"), "-o", str(warm)])
        run(root, "ris", ["-i", str(data / "tiny_q.fa"), "-o",
                          str(warm) + ".txt", "-d", str(warm)])
    for _ in range(args.rounds):
        for name in ("A", "B", "B", "A"):
            root, db = sides[name], work / f"ab_db_{name}"
            out = work / f"ab_ris_{name}.txt"
            w_db, s_db = run(root, "db", ["-i", str(db_fa), "-o", str(db)])
            w_ris, s_ris = run(root, "ris", ["-i", str(q_fa), "-o", str(out),
                                             "-d", str(db)])
            print(f"[ab] {name} ({root}): db {w_db:.3f} s = "
                  f"{db_nt / w_db:.1f} nt/s, ris {w_ris:.3f} s = "
                  f"{n_q / w_ris:.4f} q/s (walls include process start); "
                  "stage s " + " ".join(f"{k} {v:.3f}" for k, v in sorted(
                      {**s_db, **s_ris}.items())), flush=True)
    same = hit_keys(work / "ab_ris_A.txt") == hit_keys(work / "ab_ris_B.txt")
    # the body as chip_smoke.py:body_sha256 reads it: the lines after the
    # three header lines, each ended by a newline
    bodies = {k: (work / f"ab_ris_{k}.txt").read_text().splitlines()[3:]
              for k in sides}
    differ = sum(a != b for a, b in zip(bodies["A"], bodies["B"])) + abs(
        len(bodies["A"]) - len(bodies["B"]))
    sha = {k: hashlib.sha256("".join(line + "\n" for line in v).encode())
           .hexdigest() for k, v in bodies.items()}
    print(f"[ab] A and B write the same hits: {same}; {differ} of "
          f"{len(bodies['B'])} body lines differ (energies included); body "
          f"sha256 A {sha['A']}, B {sha['B']}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
