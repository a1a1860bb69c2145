"""Command-line interface: `python -m priblast_tpu_torch {db|ris} ...`.

Flags mirror the reference CLI (reference: src/main.cpp:36-111,
src/db_construction_parameters.cpp:32-78,
src/rna_interaction_search_parameters.cpp:33-95) plus `--engine` to select
the device engine (`gpu`; `auto`, the default, is the same) or the exact
host engine, and `--device` to name the torch devices the `gpu` engine
runs on (`cuda`, the default: every card the process owns, each batch
split over them; `cpu` runs the same code with the kernels' plain
versions).
Several processes (PRIBLAST_NUM_PROCS, PRIBLAST_PROC_ID, PRIBLAST_COORD;
parallel/multihost.py) split the sequences by `-a` and merge through part
files under `-p`.
"""

from __future__ import annotations

import argparse
import sys

from priblast_tpu_torch.utils.params import (DEVICES, ENGINES, DbParams,
                                             RisParams)


def _engine_flags(q) -> None:
    q.add_argument("--engine", dest="engine", default="auto", choices=ENGINES,
                   help="gpu = the device engine on --device; auto = gpu "
                        "(never the exact engine: without a card and "
                        "without --device cpu it fails); exact = the host "
                        "engine, byte-identical to the reference")
    q.add_argument("--device", dest="device", default="cuda",
                   choices=DEVICES,
                   help="torch devices of the gpu engine: cuda = every "
                        "card this process owns (with several processes, "
                        "card c goes to process c mod their count), each "
                        "batch split over them; cpu = the CPU")
    q.add_argument("--threads", dest="threads", type=int, default=0)


def _db_parser(sub) -> None:
    q = sub.add_parser("db", help="construct an interaction database")
    q.add_argument("-i", dest="input", required=True, help="input FASTA")
    q.add_argument("-o", dest="db_name", default="", help="output db name")
    q.add_argument("-r", dest="repeat_flag", type=int, default=0,
                   help="repeat mask: 0 hard, 1 soft, 2 none")
    q.add_argument("-s", dest="hash_size", type=int, default=8)
    q.add_argument("-w", dest="maximal_span", type=int, default=70)
    q.add_argument("-d", dest="min_accessible_length", type=int, default=5)
    q.add_argument("-c", dest="chunk_size", type=int, default=2**31 - 1,
                   help="db page size (sequences per page)")
    q.add_argument("-a", dest="algorithm", default="heap",
                   choices=["block", "heap", "dynamic"],
                   help="multi-process sequence distribution strategy: "
                        "block = contiguous blocks, heap and dynamic = "
                        "longest-first over the processes' loads "
                        "(single-process runs schedule dynamically)")
    q.add_argument("-p", dest="tmp_path", default="",
                   help="directory for multi-process part files (default: "
                        "beside the output)")
    _engine_flags(q)


def _ris_parser(sub) -> None:
    q = sub.add_parser("ris", help="search RNA interactions against a db")
    q.add_argument("-i", dest="input", required=True, help="query FASTA")
    q.add_argument("-o", dest="output", required=True, help="output CSV")
    q.add_argument("-d", dest="db_name", required=True, help="database name")
    q.add_argument("-l", dest="max_seed_length", type=int, default=20)
    q.add_argument("-e", dest="hybrid_energy_threshold", type=float,
                   default=-6.0)
    q.add_argument("-f", dest="interaction_energy_threshold", type=float,
                   default=-4.0)
    q.add_argument("-g", dest="final_threshold", type=float, default=-8.0)
    q.add_argument("-x", dest="drop_out_length_w_gap", type=int, default=16)
    q.add_argument("-y", dest="drop_out_length_wo_gap", type=int, default=5)
    q.add_argument("-m", dest="min_helix_length", type=int, default=3)
    q.add_argument("-s", dest="output_style", type=int, default=0)
    q.add_argument("-a", dest="algorithm", default="area",
                   choices=["block", "area", "dynamic"],
                   help="multi-process query distribution strategy: "
                        "block = contiguous blocks, area = longest-first "
                        "fill to the mean length per process, dynamic = "
                        "longest-first over the processes' loads "
                        "(single-process runs schedule dynamically)")
    q.add_argument("-p", dest="tmp_path", default="",
                   help="directory for multi-process part files (default: "
                        "beside the output)")
    q.add_argument("--dtype", dest="dtype", default="float32",
                   choices=["float32", "float64"],
                   help="device-engine dtype: float64 gives ~1e-9 kcal/mol "
                        "accessibility agreement with --engine exact")
    _engine_flags(q)


def _params(cls, ns):
    fields = set(cls.__dataclass_fields__)
    return cls(**{k: v for k, v in vars(ns).items() if k in fields})


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="priblast_tpu_torch")
    sub = ap.add_subparsers(dest="mode", required=True)
    _db_parser(sub)
    _ris_parser(sub)
    ns = ap.parse_args(argv)

    if ns.mode == "db":
        from priblast_tpu_torch.models import db

        db.run(_params(DbParams, ns), threads=ns.threads or None)
    else:
        from priblast_tpu_torch.models import ris

        ris.run(_params(RisParams, ns), threads=ns.threads or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
