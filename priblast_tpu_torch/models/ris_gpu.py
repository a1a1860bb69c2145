"""Device path of the ris step, with its host/device router.

Per wave of queries: accessibility runs on the device in length-bucketed
batches (the per-query hot DP, reference: src/rna_interaction_search.cpp:175),
then the router sends the wave to one of two search chains:
- the device chain, the cross-query search pipeline (search/pipeline.py):
  host seed DFS, then expansion, the ungapped kernel and the threshold on
  the device (search/fused.py), host dedup, the gapped kernel on the
  device and the host finish;
- the host chain, the native seed-and-extend engine per query on a thread
  pool, on the same device-computed accessibilities.
Hit semantics are identical to the exact engine; energies carry the device
dtype's accumulation noise on the device chain (use --engine exact for
byte parity). The device work of both (accessibility, and the device
chain's stages) is split over the process's list of devices
(parallel/dist.py); the router counts the distinct ones as the device
side's width.

A failure on the device is not retried on the host: it ends the run.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import sys
import time

import numpy as np

from priblast_tpu_torch.models import db_gpu
from priblast_tpu_torch.ops import native
from priblast_tpu_torch.parallel import dist
from priblast_tpu_torch.utils import alphabet
from priblast_tpu_torch.utils import profiling as prof
from priblast_tpu_torch.utils.params import RisParams


def device_extend_mode() -> str:
    """Which chain extends a wave's seeds, from PRIBLAST_DEVICE_EXTEND (read
    at each call): 1 always the device chain, 0 never (device
    accessibility, then the host chain), auto (the default) the router:
    one seed DFS on the host, then the whole wave to the chain
    device_extend_wins picks."""
    v = os.environ.get("PRIBLAST_DEVICE_EXTEND", "auto").lower()
    if v in ("0", "false", "never"):
        return "never"
    if v in ("1", "true", "always"):
        return "always"
    return "auto"


# The router's rates, from the [router] line of chip_smoke.py run from a
# `git archive` of a tree that differed from this one only in these five
# numbers and in comments (the gapped stage's overflow re-runs on a pool
# of threads - 1 beside its hit batches): the smoke workload (bench.py's
# size, one wave of 100 queries, 12,681,462 candidate pairs, 1,249,785
# hits after the mid stage) on an NVIDIA H100 80GB HBM3, 700.00 W, whose
# host has 8 cores (os.cpu_count() and the affinity mask both 8); a
# candidate pair is one of the products of a seed candidate's two
# suffix-array interval sizes:
# - HOST_PAIR_RATE: pairs / (host chain wall x its 8 threads), per thread;
# - DEV_PAIR_RATE: pairs / (ris.seed + ris.fused) of the device chain
#   (measured again once the fused stage's expansion and threshold became
#   kernels, from a tree that differed from this one in it alone; the
#   other four are older);
# - HIT_DENSITY: hits after the mid stage / pairs;
# - DEV_HIT_RATE: hits after the mid stage / (ris.mid + ris.gapped +
#   ris.finish);
# - DEV_DISPATCH_S: the device chain's wall on a one-query wave (the
#   shortest query; the median of three).
HOST_PAIR_RATE = 2.011e5
DEV_PAIR_RATE = 2.915e7
DEV_HIT_RATE = 5.845e5
HIT_DENSITY = 0.09855
DEV_DISPATCH_S = 0.0614


def device_extend_wins(n_pairs: int, threads: int, n_dev: int) -> bool:
    """Winner-take-all estimate: the device chain against the host chain
    for a wave of `n_pairs` candidate pairs, on `threads` host threads and
    `n_dev` devices. The device side carries its fixed per-wave cost, so
    tiny waves stay on the host."""
    host_t = n_pairs / (HOST_PAIR_RATE * max(threads, 1))
    dev_t = (DEV_DISPATCH_S
             + n_pairs / (DEV_PAIR_RATE * n_dev)
             + n_pairs * HIT_DENSITY / (DEV_HIT_RATE * n_dev))
    return dev_t < host_t


# The wave budget: query nt x database nt that one pass of the device chain
# (a wave of queries against a group of pages) may hold. The host arrays of
# a pass (the seed candidates, the fused stage's records, the stream after
# the threshold with its pre_* copies, the base pairs) grow with its
# candidate pairs, and those with query nt x database nt. On the host of an
# NVIDIA H100 80GB HBM3 (700 W; 96 GiB, 8 cores) the peak resident memory
# over a job of the device chain, less that before it, was 0.079-0.103 B
# per (query nt x target nt), ~65 B per candidate pair: 8 jobs of 2-32
# lncRNA-like queries (1,908-32,428 nt) against 1 and 8 pages of 500
# mRNA-like targets (1.5 and 12.1 Mnt), 2.0e10-3.9e11 nt^2 a job. 16 GiB,
# a sixth of that host, over the largest reading is 1.67e11, rounded down.
# A rank's job of hundreds of 1 kb queries against a few hundred pages
# (~300 Mnt) holds 1e14 and more.
WAVE_NT2 = 160_000_000_000


def _wave_plan(order, lengths, db_nt: int = 0, budget: float = WAVE_NT2,
               max_nt: int = 4 << 20, max_q: int = 1024):
    """Split queries (descending-length order) into waves bounded by total
    nucleotides and count, so flat device buffers stay bounded, and by
    total nucleotides x `db_nt` (the database's) <= `budget`; a wave holds
    at least one query."""
    cap = min(max_nt, budget // max(db_nt, 1))
    wave: list[int] = []
    nt = 0
    for idx in order:
        if wave and (nt + lengths[idx] > cap or len(wave) >= max_q):
            yield wave
            wave, nt = [], 0
        wave.append(idx)
        nt += lengths[idx]
    if wave:
        yield wave


def _page_groups(page_nt, wave_nt: int, budget: float = WAVE_NT2):
    """The pages (their nt in page order) in runs searched in turn against
    a wave of `wave_nt` query nt, each run's nt x wave_nt within `budget`;
    a run holds at least one page. One run of every page wherever the wave
    fits the budget against the whole database."""
    groups: list[list[int]] = []
    run: list[int] = []
    nt = 0
    for cid, n in enumerate(page_nt):
        if run and (nt + n) * wave_nt > budget:
            groups.append(run)
            run, nt = [], 0
        run.append(cid)
        nt += n
    if run:
        groups.append(run)
    return groups


def _accessibility_batched(engine, seqs, lengths, idxs):
    """Device accessibility for the given query indices; returns
    {idx: (acc, cond)} float32 arrays of per-sequence length."""
    return {idx: (np.ascontiguousarray(acc[: lengths[idx]]),
                  np.ascontiguousarray(cond[: lengths[idx]]))
            for idx, acc, cond in db_gpu.run_planned(engine, seqs, lengths,
                                                     idxs)}


def run_queries(p: RisParams, chunks, names, seqs, order, results, *,
                devices, threads: int | None = None,
                budget: float = WAVE_NT2) -> None:
    """Fill results[idx] with the formatted lines of every query idx in
    `order`: accessibility split over `devices` (one device or a list),
    then each wave searched on the device chain (its device stages split
    over `devices`) or the host chain (device_extend_mode, route). Waves
    hold at most `budget` query nt x database nt; a wave of one query over
    the budget searches the pages in runs (_page_groups), in page order,
    so each query's lines keep the reference's order: query, then page."""
    from priblast_tpu_torch.accessibility.batched import BatchedRaccess
    from priblast_tpu_torch.search import pipeline as pl

    devices = dist.device_list(devices)
    engine = BatchedRaccess(p.maximal_span, p.min_accessible_length,
                            dtype=p.dtype, devices=devices)
    native.lib()
    threads = threads or min(32, os.cpu_count() or 1)
    lengths = [len(s) for s in seqs]
    page_nt = [len(c.seqs) for c in chunks]
    mode = device_extend_mode()
    dbpack = None
    done_q, t_start = 0, time.perf_counter()
    for wave in _wave_plan(order, lengths, sum(page_nt), budget):
        with prof.stage("ris.accessibility", devices):
            accs = _accessibility_batched(engine, seqs, lengths, wave)
        queries = []
        for idx in wave:
            q_enc = alphabet.encode_query(seqs[idx], p.repeat_flag)
            queries.append((q_enc, native.sa_build(q_enc), *accs[idx]))
            results[idx] = []
        wave_nt = sum(lengths[idx] for idx in wave)
        for cids in _page_groups(page_nt, wave_nt, budget):
            prof.count("ris.waves")
            pages = [chunks[c] for c in cids]
            split = route(p, pages, queries, mode, devices, threads)
            if split[1] and dbpack is None:
                with prof.stage("ris.dbpack"):
                    dbpack = pl.DbPack(chunks, devices=devices)
                prof.count("ris.dbpack.bytes", dbpack.device_bytes())
            found = _search_wave(p, pages, [names[i] for i in wave],
                                 queries, split,
                                 None if dbpack is None
                                 else dbpack.pages(cids), devices, threads)
            for qid, lines in found.items():
                results[wave[qid]].extend(lines)
        done_q += len(wave)
        if os.environ.get("PRIBLAST_PROGRESS"):
            el = max(time.perf_counter() - t_start, 1e-9)
            print(f"[ris] {done_q} queries, {el:.0f}s ({done_q / el:.3f} "
                  "q/s)", file=sys.stderr, flush=True)


def route(p, chunks, queries, mode: str, devices, threads: int):
    """Which chain searches a wave: returns (host qids, device qids, the
    seed candidates or None, pairs per qid), one of the two lists empty.
    In `auto` the host seeds the wave once, device_extend_wins picks the
    chain, and the device chain reuses the candidates. The device side's
    rate counts the distinct devices of `devices` (a card listed twice, as
    two shards on one card, is one card's rate), as the JAX package counts
    its mesh, which never holds a device twice."""
    from priblast_tpu_torch.search import seed

    every = list(range(len(queries)))
    if mode == "always":
        return [], every, None, {}
    if mode == "never":
        return every, [], None, {}
    with prof.stage("ris.seed"):
        cands = seed.seed_candidates(p, chunks, queries, threads)
    pairs_by_q = dict.fromkeys(every, 0)
    for (qid, _cid), c in cands:
        pairs_by_q[qid] += seed.n_pairs(c)
    n_dev = len(dist.distinct(devices))
    if device_extend_wins(sum(pairs_by_q.values()), threads, n_dev):
        return [], every, cands, pairs_by_q
    return every, [], cands, pairs_by_q


def _search_wave(p, chunks, q_names, queries, split, dbpack, devices,
                 threads: int) -> dict[int, list[str]]:
    """Search one wave's queries on the chain `split` (route's result)
    assigns them. Returns {qid: formatted lines}. An exception on the
    device chain ends the run: its queries are not searched again on the
    host."""
    from priblast_tpu_torch.models.ris import format_hits
    from priblast_tpu_torch.search import pipeline as pl

    host_qids, dev_qids, cands, _pairs_by_q = split

    def q_length(qid):
        q_enc = queries[qid][0]
        return int(np.count_nonzero((q_enc >= 2) & (q_enc <= 5)))

    def host_search(qid):
        q_enc, q_sa, q_acc, q_cond = queries[qid]
        lines: list[str] = []
        for chunk in chunks:
            res = native.search_chunk(q_enc, q_sa, q_acc, q_cond, chunk, p)
            lines.extend(format_hits(p, res, chunk, q_names[qid],
                                     q_length(qid)))
        return lines

    if host_qids:
        with cf.ThreadPoolExecutor(threads) as ex:
            return dict(zip(host_qids, ex.map(host_search, host_qids)))
    qpack = pl.QueryPack([q[0] for q in queries], [q[2] for q in queries],
                         [q[3] for q in queries], [q[1] for q in queries],
                         devices=devices)
    stream, finished = pl.search_all(p, chunks, queries, qpack, dbpack,
                                     devices=devices, threads=threads,
                                     dtype=p.dtype, cands=cands)
    with prof.stage("ris.format"):
        found: dict[int, list[str]] = {qid: [] for qid in dev_qids}
        for (qid, cid, _lo, _hi), res in zip(stream.groups, finished):
            found[qid].extend(format_hits(p, res, chunks[cid], q_names[qid],
                                          q_length(qid)))
    return found
