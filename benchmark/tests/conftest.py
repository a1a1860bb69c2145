"""The benchmark's own tests (python -m pytest benchmark/tests). Most run
on the CPU at tiny sizes; tests marked `gpu` need the card and skip here."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH.parent))
sys.path.insert(0, str(BENCH))
