"""On the card: one short run of each cell through run.py, `correct`
true, the device the card. Skips without a card (decided in the test, not
at import)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["ris.lnc_x_rna", "db.lnc_x_lnc"])
def test_cell_runs_correct_on_the_card(card, cell):
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 99), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["compared"]
    assert out["device"]["platform"] == "gpu"
    # on the card every end-to-end metric of the cell is read, those from
    # the device trace too
    from pbench import spec as specmod

    spec = specmod.load_spec()
    assert set(out["metrics"]) == {m["name"]
                                   for m in specmod.end_to_end(spec, cell)}
