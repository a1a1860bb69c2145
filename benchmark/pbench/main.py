"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result's line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with --trace 1 `breakdown`,
and last `compared`: each number the check compared, with its limit);
the same numbers close standard error. With --trace 0 the metrics are the
cell's end-to-end metrics, with --trace 1 its per-layer metrics, read in
a run whose window runs under torch.profiler."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

from pbench import spec as specmod

# top-level modules no process that prints a result may hold: the JAX
# package and JAX itself (the port's name begins with the JAX package's,
# so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "priblast_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What one run knows: its cell, configuration and traffic, its seed
    and window, and what the window did (filled by the traffic's kind)."""

    def __init__(self, spec, cell, seed, seconds, trace, device, tmp,
                 root=specmod.ROOT, t0=None, traffic_dir=None):
        self.spec, self.cell, self.seed = spec, cell, int(seed)
        self.seconds, self.trace = float(seconds), bool(trace)
        # the window runs under torch.profiler in a traced run, and in
        # every run of a cell with an end-to-end metric from the trace
        self.profile = self.trace or any(
            m["source"] == "device_trace"
            for m in specmod.end_to_end(spec, cell["name"]))
        self.device, self.tmp, self.root = device, Path(tmp), Path(root)
        self.t0 = time.perf_counter() if t0 is None else t0
        self.config = specmod.load_config(spec, cell["config"], self.root)
        self.traffic = specmod.load_traffic(cell["traffic"], traffic_dir)
        # filled by the kind
        self.jobs: list[dict] = []       # one record per job of the window
        self.work_nt = 0.0               # the nucleotides the window did
        self.window_s = 0.0
        self.spans: dict[str, float] = {}
        self.devtrace = None             # devtrace.Trace in a traced run
        self.attempted = self.failed = 0
        self.setup_s = 0.0
        self.control: dict = {}          # the control's readings

    def log(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def _device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def _env(root: Path) -> None:
    """Every build and kernel cache of the program inside the checkout, at
    fixed paths (the program's own builds go to build/kernels and
    build/native there already)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_cache")):
        os.environ[var] = str(root / "build" / sub)


def execute(spec: dict, workload: str, seed: int, seconds: float,
            trace: bool, *, device=None, root: Path = specmod.ROOT,
            t0: float | None = None, control: bool = False,
            tmp_parent: str | None = None, traffic_dir=None) -> dict:
    """Runs one cell and returns the result's object (its `compared`
    last). `device` None: the card, which must be there."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = specmod.workload(spec, workload)
    import torch

    if device is None:
        device = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="pbench_", dir=tmp_parent)
    try:
        run = Run(spec, cell, seed, seconds, trace, device, tmp, root, t0,
                  traffic_dir)
        kind = specmod.kind_module(run.traffic["kind"])
        state = kind.setup(run)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        run.setup_s = time.perf_counter() - t0
        run.log(f"[setup] {run.setup_s:.3f} s")
        kind.window(run, state)
        devinfo = _device_info(device)
        compared = kind.check(run, state, control=control)
        metrics = {}
        if trace:
            for m in specmod.per_layer(spec, workload):
                v = specmod.metric_module(m["name"]).read(run)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            for m in specmod.end_to_end(spec, workload):
                v = run.setup_s if m["name"] == "setup_s" else \
                    kind.end_to_end(run, m["name"])
                if v is None and specmod.has_metric_module(m["name"]):
                    v = specmod.metric_module(m["name"]).read(run)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if trace and run.devtrace is not None:
            devinfo["busy_s"] = run.devtrace.busy_s
            devinfo["window_s"] = run.devtrace.window_s
        correct = run.failed == 0 and all(
            c["value"] <= c["limit"] for c in compared.values())
        out = {"correct": bool(correct), "attempted": run.attempted,
               "failed": run.failed, "metrics": metrics, "device": devinfo}
        if trace and run.devtrace is not None:
            out["breakdown"] = run.devtrace.breakdown()
        if control:
            out["control"] = run.control
        out["compared"] = compared
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="also read the check's control, the reference in "
                    "the precision below the configuration's in the "
                    "program's place (for setting limits; the driver's "
                    "runs do not use it)")
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    _env(specmod.ROOT)
    spec = specmod.load_spec()
    cell = specmod.workload(spec, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = execute(spec, args.workload, args.seed, args.seconds,
                  bool(args.trace), t0=t0, control=args.control)
    bad = forbidden_modules()
    if bad:
        print("the process holds " + ", ".join(bad) + ": the benchmark may "
              "load neither JAX nor the JAX package", file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
