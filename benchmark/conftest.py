"""Loaded before benchmark/tests/conftest.py. The tests' tiny spec
(tests/tiny.py) renames every cell that a metric's `workloads` lists to a
tiny cell of the same kind through its `CELLS` map; this adds the cells
BENCHMARK.json gained after that map was written: the 8-page ris cell as
the tiny multi-page cell `ris.tiny.pages` (tests/test_bench_pages.py),
the mRNA-page db cell as `db.tiny`."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for path in (BENCH.parent, BENCH, BENCH / "tests"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

import tiny  # noqa: E402

tiny.CELLS.setdefault("ris.lnc_x_rna.8pages", "ris.tiny.pages")
tiny.CELLS.setdefault("db.lnc_x_rna", "db.tiny")
