"""A whole run of each tiny cell on the CPU (the look for a card
skipped): the result's line has exactly the contract's keys, `compared`
last, and the check passes on the program as it is; and run.py itself
refuses to run without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

import tiny

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


@pytest.fixture(autouse=True)
def _device_chain(monkeypatch):
    # on the CPU the router sends tiny waves to the host chain; the device
    # chain is the cells' path on the card
    monkeypatch.setenv("PRIBLAST_DEVICE_EXTEND", "1")


@pytest.mark.parametrize("cell", ["ris.tiny", "db.tiny"])
def test_last_line_keys(cell, tmp_path):
    out = tiny.run(cell, tmp=str(tmp_path))
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    spec = tiny.spec()
    mine = [m for m in spec["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]
    # on the CPU no kernel runs, so a metric read from the device trace
    # finds nothing and is left out, never reported as 0
    assert set(out["metrics"]) == {m["name"] for m in mine
                                   if m["source"] == "host_clock"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(out["device"])
    for c in out["compared"].values():
        assert set(c) == {"value", "limit"}
    json.loads(tiny.dump(out))


def test_traced_run_reads_per_layer_metrics(tmp_path):
    out = tiny.run("ris.tiny", trace=True, tmp=str(tmp_path))
    assert list(out) == KEYS[:5] + ["breakdown", "compared"]
    names = {m["name"] for m in tiny.spec()["per_layer"]
             if "ris.tiny" in m["workloads"]}
    assert set(out["metrics"]) <= names
    for key in ("ris_gapped_s_per_qmnt", "ris_mid_s_per_qmnt",
                "ris_fused_s_per_qmnt", "device_idle_share.ris"):
        assert key in out["metrics"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10


def test_run_py_refuses_without_a_card():
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "db.lnc_x_lnc",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.mark.parametrize("cell,profiled", [("ris.tiny", True),
                                           ("db.tiny", False)])
def test_untraced_window_profiled_only_for_a_trace_metric(cell, profiled,
                                                          tmp_path):
    # a cell with an end-to-end metric from the device trace runs its
    # --trace 0 window under the profiler too; the others do not
    import torch
    from pbench import main
    from pbench import spec as specmod

    spec = tiny.spec()
    run = main.Run(spec, specmod.workload(spec, cell), 1, 1.0, False,
                   torch.device("cpu"), tmp_path, traffic_dir=tiny.DATA)
    assert run.profile is profiled
    assert main.Run(spec, specmod.workload(spec, cell), 1, 1.0, True,
                    torch.device("cpu"), tmp_path,
                    traffic_dir=tiny.DATA).profile is True
