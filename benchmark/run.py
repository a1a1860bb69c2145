#!/usr/bin/env python3
"""Runs one cell of the port's benchmark on the card, from the root of a
checkout:

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

See benchmark/README.md."""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(_HERE.parent))  # the program: priblast_tpu_torch
sys.path.insert(0, str(_HERE))         # the harness and the reference

if __name__ == "__main__":
    from pbench import main

    sys.exit(main.main(sys.argv[1:], T0))
