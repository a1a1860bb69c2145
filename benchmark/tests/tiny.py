"""Tiny cells for the CPU tests: BENCHMARK.json's metrics over two cells
of small pages and jobs (configs and traffic in tests/data/)."""

import copy
import json
from pathlib import Path

from pbench import spec as specmod

DATA = Path(__file__).resolve().parent / "data"
CELLS = {"ris.lnc_x_rna": "ris.tiny", "db.lnc_x_lnc": "db.tiny"}


def spec() -> dict:
    real = specmod.load_spec()
    out = copy.deepcopy(real)
    out["configs"] = [
        {"name": "tiny_rna", "source": "tests", "reduced": [], "why": "test",
         "file": "benchmark/tests/data/tiny_rna.json"},
        {"name": "tiny_lnc", "source": "tests", "reduced": [], "why": "test",
         "file": "benchmark/tests/data/tiny_lnc.json"}]
    out["workloads"] = [
        {"name": "ris.tiny", "config": "tiny_rna", "traffic": "tiny_ris",
         "chips": 1, "why": "test"},
        {"name": "db.tiny", "config": "tiny_lnc", "traffic": "tiny_db",
         "chips": 1, "why": "test"}]
    for group in ("end_to_end", "per_layer"):
        for m in out[group]:
            if "workloads" in m:
                m["workloads"] = [CELLS[w] for w in m["workloads"]]
    return out


def run(cell, seed=2**31 + 17, trace=False, control=False, tmp=None):
    """One tiny run on the CPU; returns the result's object."""
    import torch
    from pbench import main

    return main.execute(spec(), cell, seed, 0.5, trace,
                        device=torch.device("cpu"), control=control,
                        tmp_parent=tmp, traffic_dir=DATA)


def dump(out) -> str:
    return json.dumps(out)
