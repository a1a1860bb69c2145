"""Database-construction pipeline (the reference's `db` step;
src/db_construction.cpp:37-83).

Stages:
  1. read FASTA
  2. per-sequence accessibility DP (exact host engine, or the batched
     PyTorch engine with --engine gpu, each batch split over the
     process's devices) — the hot stage
  3. search-encode all sequences (reversed + sentinels)
  4. per page of `chunk_size` sequences: suffix array + k-mer hash
  5. write .bas/.seq/.ind/.acc/.nam (byte-compatible with the reference)

Host parallelism replaces the reference's MPI rank distribution: the exact
engine processes sequences in descending-length order (LPT) across a
thread pool; output files are always written in FASTA order, so results
are independent of the schedule.
"""

from __future__ import annotations

import concurrent.futures as cf
import os

import numpy as np

from priblast_tpu_torch.ops import native
from priblast_tpu_torch.utils import alphabet, fasta, store
from priblast_tpu_torch.utils import profiling as prof
from priblast_tpu_torch.utils.params import DbParams


def compute_accessibilities_exact(seqs: list[str], w: int, d: int,
                                  threads: int | None = None):
    """Exact per-sequence accessibility, parallel over sequences (LPT order)."""
    n = len(seqs)
    accs: list[np.ndarray | None] = [None] * n
    conds: list[np.ndarray | None] = [None] * n
    order = native.argsort_desc([len(s) for s in seqs])
    native.lib()  # build/load + set params once before starting threads

    def work(idx: int) -> None:
        acc, cond = native.raccess(alphabet.access_codes(seqs[idx]), w, d)
        accs[idx] = acc[: max(len(seqs[idx]) - d + 1, 0)]
        conds[idx] = cond

    threads = threads or min(32, os.cpu_count() or 1)
    if threads > 1 and n > 1:
        with cf.ThreadPoolExecutor(threads) as ex:
            list(ex.map(work, [int(i) for i in order]))
    else:
        for i in order:
            work(int(i))
    return accs, conds


def run(p: DbParams, threads: int | None = None, devices=None) -> None:
    """The db step. `devices`: the gpu engine's torch devices (one or a
    list), in place of every card this process owns (`--device cuda`) or
    the CPU (`--device cpu`)."""
    from priblast_tpu_torch.parallel import multihost

    p.validate()
    pidx, pcount = multihost.init_from_env()
    try:
        with prof.command("db"):
            _run(p, threads, pidx, pcount, devices)
    finally:
        multihost.shutdown()


def _run(p: DbParams, threads: int | None, pidx: int, pcount: int,
         devices=None) -> None:
    from priblast_tpu_torch.parallel import dist, multihost

    if p.engine != "gpu":
        devices = None
    elif devices is None:
        devices = dist.local_devices(p.device, pidx, pcount)
    else:
        devices = dist.device_list(devices)
    with prof.stage("db.read"):
        names, seqs = fasta.read_fasta(p.input)
    if pcount > 1:
        mine = sorted(multihost.partition_for(
            p.algorithm, [len(s) for s in seqs], pcount)[pidx])
        my_seqs = [seqs[i] for i in mine]
    else:
        mine, my_seqs = list(range(len(seqs))), seqs

    with prof.stage("db.accessibility", devices):
        if devices is not None:
            from priblast_tpu_torch.models import db_gpu

            accs, conds = db_gpu.compute_accessibilities(
                my_seqs, p.maximal_span, p.min_accessible_length,
                devices=devices)
        else:
            accs, conds = compute_accessibilities_exact(
                my_seqs, p.maximal_span, p.min_accessible_length, threads)

    if pcount > 1:
        # gather the accessibility shards to process 0, which builds the
        # index (the analog of the reference's gather to one rank before
        # the index build, src/db_construction.cpp:239-328)
        multihost.write_acc_part(
            multihost.part_path(p.db_name, p.tmp_path, pidx),
            {i: accs[k] for k, i in enumerate(mine)},
            {i: conds[k] for k, i in enumerate(mine)})
        multihost.barrier("db_acc_parts")
        if pidx != 0:
            prof.maybe_report()
            return
        parts = [multihost.part_path(p.db_name, p.tmp_path, q)
                 for q in range(pcount)]
        accs, conds = multihost.read_acc_parts(parts, len(seqs))
        for part in parts:
            part.unlink()

    with prof.stage("db.index"):
        encoded_each = [alphabet.encode_db([s], p.repeat_flag) for s in seqs]
        sizes = np.array([len(s) for s in seqs], dtype=np.int32)
        n = len(seqs)
        chunk = p.chunk_size
        num_chunks = max(1, (n + chunk - 1) // chunk)
        for ci in range(num_chunks):
            lo, hi = ci * chunk, min(n, (ci + 1) * chunk)
            enc = (np.concatenate(encoded_each[lo:hi]) if hi > lo
                   else np.zeros(0, np.uint8))
            sa = native.sa_build(enc)
            hstart, hend = native.kmer_hash(enc, sa, p.hash_size)
            store.append_ind_chunk(p.db_name, sa, hstart, hend,
                                   first=(ci == 0))
            store.append_seq_chunk(p.db_name, sizes[lo:hi], enc,
                                   first=(ci == 0))

    with prof.stage("db.write"):
        store.write_acc(p.db_name, accs, conds)
        store.write_nam(p.db_name, names)
        store.write_bas(p.db_name, p.hash_size, p.repeat_flag,
                        p.maximal_span, p.min_accessible_length)
    prof.maybe_report()
