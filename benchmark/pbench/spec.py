"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The configuration's file is the one its entry in `configs` names; the
traffic mix is benchmark/traffic/<traffic>.json; its `kind` names the
module benchmark/pbench/kinds/<kind>.py that drives it; each per-layer
metric is read by benchmark/metrics/<metric name>.py. Adding a cell, a
configuration, a traffic mix or a metric is adding files and entries."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_spec(path: Path | None = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_entry(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def load_config(spec: dict, name: str, root: Path = ROOT) -> dict:
    return json.loads((root / config_entry(spec, name)["file"]).read_text())


def load_traffic(name: str, traffic_dir: Path | None = None) -> dict:
    path = Path(traffic_dir or BENCH_DIR / "traffic") / f"{name}.json"
    return json.loads(path.read_text())


def _module(path: Path, modname: str):
    if not path.exists():
        raise SystemExit(f"no file {path}")
    sp = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def kind_module(kind: str):
    """The driver of a traffic kind: pbench/kinds/<kind>.py."""
    return _module(BENCH_DIR / "pbench" / "kinds" / f"{kind}.py",
                   f"pbench_kind_{kind}")


def has_metric_module(name: str) -> bool:
    return (BENCH_DIR / "metrics" / f"{name}.py").exists()


def metric_module(name: str):
    """The reader of a metric: metrics/<name>.py (every per-layer metric;
    an end-to-end metric its traffic kind does not compute itself)."""
    return _module(BENCH_DIR / "metrics" / f"{name}.py",
                   "pbench_metric_" + re.sub(r"\W", "_", name))


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(spec: dict, cell: str) -> list[dict]:
    return [m for m in spec["end_to_end"] if applies(m, cell)]


def per_layer(spec: dict, cell: str) -> list[dict]:
    """The cell's per-layer metrics: those that list it, and those with no
    list that move an end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(spec, cell)}
    out = []
    for m in spec["per_layer"]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out
