"""Several processes (torch.distributed) for the db and ris steps.

The reference distributes sequences across MPI ranks and merges outputs
with rank-ordered rings (src/fastafile_reader.cpp:135-314,
src/rna_interaction_search.cpp:202-230, src/db_construction.cpp:239-328).
Here:

- every process reads the FASTA and takes the shard of sequence indices
  chosen by the `-a` distribution strategy (block / heap-LPT / area-sum;
  `dynamic` falls back to LPT: static balanced shards, no work-stealing
  counter);
- each process computes its shard on its own device and writes one part
  file (the analog of the reference's per-rank temp files,
  src/utils.cpp:65-87), to `-p tmp_path` if given;
- a barrier replaces the token ring, and process 0 merges the parts in
  global order (deterministic output, unlike the reference's
  completion-order chaining).

Only the barrier crosses processes, so the group is gloo's, which runs on
the CPU as well as beside a card. Activation: set PRIBLAST_NUM_PROCS and
PRIBLAST_PROC_ID (and PRIBLAST_COORD, default localhost:9911, the address
of process 0's rendezvous) on every process; PRIBLAST_DIST_TIMEOUT (seconds,
default 1800) bounds the rendezvous and the barrier, so a lost peer ends
the run with an error. Single-process runs are unaffected.
"""

from __future__ import annotations

import datetime
import os
import socket
from pathlib import Path

import numpy as np

from priblast_tpu_torch.parallel import dist as pdist
from priblast_tpu_torch.utils import fasta

# each process's host name, by index, while a group joined by
# init_from_env is up
_HOSTS: list[str] = []


def init_from_env() -> tuple[int, int]:
    """Join the process group named by the PRIBLAST_* variables, once per
    run. Returns (process index, process count); (0, 1) and no group for
    one process."""
    nprocs = int(os.environ.get("PRIBLAST_NUM_PROCS", "0") or 0)
    if nprocs <= 1:
        return 0, 1
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group(
            "gloo",
            init_method="tcp://" + os.environ.get("PRIBLAST_COORD",
                                                  "localhost:9911"),
            rank=int(os.environ["PRIBLAST_PROC_ID"]), world_size=nprocs,
            timeout=datetime.timedelta(seconds=float(
                os.environ.get("PRIBLAST_DIST_TIMEOUT", "1800"))))
        hosts = [None] * nprocs
        dist.all_gather_object(hosts, socket.gethostname())
        _HOSTS[:] = hosts
    return dist.get_rank(), dist.get_world_size()


def shutdown() -> None:
    """Leave the process group, if any, at the end of a run, so that a
    later run in the same process starts clean."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _HOSTS.clear()


def card_sharers() -> int:
    """The processes of the run's group that share this process's card
    (dist.card_sharers, by the hosts gathered when the group was joined);
    1 without a group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return pdist.card_sharers(dist.get_rank(), dist.get_world_size(),
                              _HOSTS or None)


def barrier(name: str) -> None:
    """Cross-process barrier (replaces the reference's token ring,
    src/db_construction.cpp:591-610); `name` says which one in a
    traceback."""
    import torch.distributed as dist

    dist.barrier()


def partition_for(algorithm: str, lengths: list[int],
                  parts: int) -> list[list[int]]:
    """Sequence-index shards per process, by distribution strategy
    (reference `-a` flag; src/fastafile_reader.cpp:135-314)."""
    if algorithm == "block":
        return fasta.partition_block(len(lengths), parts)
    if algorithm == "area":
        return fasta.partition_area(lengths, parts)
    # heap and dynamic: LPT (dynamic's work stealing becomes the same
    # balancing intent, statically)
    return fasta.partition_lpt(lengths, parts)


def part_path(output: str, tmp_path: str, pidx: int) -> Path:
    base = Path(tmp_path) if tmp_path else Path(output).parent
    base.mkdir(parents=True, exist_ok=True)
    return base / f"{Path(output).name}.part{pidx}"


# ---- ris: per-query result lines ----------------------------------------

def write_ris_part(path: Path, results: dict[int, list[str]]) -> None:
    """Framed text part file: '#q <query index> <n lines>' blocks."""
    with open(path, "w") as f:
        for idx in sorted(results):
            lines = results[idx]
            f.write(f"#q {idx} {len(lines)}\n")
            for line in lines:
                f.write(line + "\n")


def read_ris_parts(paths: list[Path]) -> dict[int, list[str]]:
    out: dict[int, list[str]] = {}
    for path in paths:
        with open(path) as f:
            lines = f.read().splitlines()
        i = 0
        while i < len(lines):
            tag, idx, n = lines[i].split()
            if tag != "#q":
                raise ValueError(f"{path}: line {i + 1} is not a '#q' frame")
            idx, n = int(idx), int(n)
            out[idx] = lines[i + 1: i + 1 + n]
            i += 1 + n
    return out


# ---- db: per-sequence accessibility arrays -------------------------------

def write_acc_part(path: Path, accs: dict[int, np.ndarray],
                   conds: dict[int, np.ndarray]) -> None:
    arrays = {}
    for idx, a in accs.items():
        arrays[f"a{idx}"] = a
        arrays[f"c{idx}"] = conds[idx]
    with open(path, "wb") as fh:  # exact path (savez would append .npz)
        np.savez(fh, **arrays)


def read_acc_parts(paths: list[Path], n: int):
    accs: list[np.ndarray | None] = [None] * n
    conds: list[np.ndarray | None] = [None] * n
    for path in paths:
        with np.load(path) as z:
            for key in z.files:
                idx = int(key[1:])
                if key[0] == "a":
                    accs[idx] = z[key]
                else:
                    conds[idx] = z[key]
    return accs, conds
