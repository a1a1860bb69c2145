"""BENCHMARK.json against the contract's shape, and the harness finding
cells, configurations, traffic mixes and metrics by name."""

import importlib.util
import json
import shutil

import pytest

from pbench import spec as specmod

ROOT = specmod.ROOT
SPEC = specmod.load_spec()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_keys():
    assert set(SPEC) == TOP
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("group,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entry_keys(group, keys):
    for e in SPEC[group]:
        assert set(e) == keys, e["name"]


def test_metric_keys():
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            yield e["name"]
    for w in SPEC["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in SPEC["configs"]:
        yield from c["reduced"]


def test_names_and_units_use_allowed_characters():
    for n in _names():
        assert specmod.NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert specmod.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for e in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for m in SPEC["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\t" not in m["layer"]


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for w in SPEC["workloads"]:
        mine = {m["name"] for m in specmod.end_to_end(SPEC, w["name"])}
        assert "setup_s" in mine and len(mine) >= 2
        layers = specmod.per_layer(SPEC, w["name"])
        assert layers
        for m in layers:
            assert m["moves"] in mine


def test_every_name_finds_its_file():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        for key in c["reduced"]:
            assert key in cfg and key in cfg["reduced"]
    for w in SPEC["workloads"]:
        tr = specmod.load_traffic(w["traffic"])
        assert specmod.kind_module(tr["kind"])
    for m in SPEC["per_layer"]:
        assert hasattr(specmod.metric_module(m["name"]), "read")


def test_new_files_are_found_by_name(tmp_path):
    """A cell, a configuration, a traffic mix and a metric added as files,
    with entries in BENCHMARK.json and no edit of the harness."""
    bench = tmp_path / "benchmark"
    shutil.copytree(specmod.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    cfg = json.loads((ROOT / spec["configs"][0]["file"]).read_text())
    cfg["targets"]["count"] = 250
    (bench / "configs" / "new_cfg.json").write_text(json.dumps(cfg))
    tr = specmod.load_traffic("ris_jobs")
    tr["queries_per_job"] = 8
    (bench / "traffic" / "new_mix.json").write_text(json.dumps(tr))
    (bench / "metrics" / "new_metric.x.py").write_text(
        "def read(run):\n    return 42.0\n")
    spec["configs"].append(dict(spec["configs"][0], name="new_cfg",
                                file="benchmark/configs/new_cfg.json"))
    spec["workloads"].append({"name": "ris.new", "config": "new_cfg",
                              "traffic": "new_mix", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "new_metric.x", "unit": "%",
                              "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "setup_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    # the copy's spec module, so that its paths are the copy's
    sp = importlib.util.spec_from_file_location(
        "copied_spec", bench / "pbench" / "spec.py")
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    got = mod.load_spec()
    assert mod.workload(got, "ris.new")["traffic"] == "new_mix"
    assert mod.load_config(got, "new_cfg")["targets"]["count"] == 250
    assert mod.load_traffic("new_mix")["queries_per_job"] == 8
    assert mod.metric_module("new_metric.x").read(None) == 42.0
    assert "new_metric.x" in [m["name"] for m in mod.per_layer(got, "ris.new")]
    assert "new_metric.x" in [m["name"]
                              for m in mod.per_layer(got, "db.lnc_x_lnc")]


def test_size_and_cells():
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["workloads"]) <= 24
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_trace_end_to_end_metrics_have_readers():
    for m in SPEC["end_to_end"]:
        if m["source"] == "device_trace":
            assert specmod.has_metric_module(m["name"]), m["name"]


def test_kernel_seconds_per_query_mnt_from_the_trace():
    from types import SimpleNamespace as NS

    read = specmod.metric_module("ris_kernel_s_per_qmnt").read
    trace = NS(kernels=[("a", 0.25), ("b", 0.5)])
    assert read(NS(devtrace=trace, work_nt=2e5)) == pytest.approx(3.75)
    assert read(NS(devtrace=NS(kernels=[]), work_nt=2e5)) is None
    assert read(NS(devtrace=None, work_nt=2e5)) is None
