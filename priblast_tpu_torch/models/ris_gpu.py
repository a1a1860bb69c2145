"""Device path of the ris step, with its host/device router.

Per wave of queries: accessibility runs on the device in length-bucketed
batches (the per-query hot DP, reference: src/rna_interaction_search.cpp:175),
then the router sends each query to one of two search chains:
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
import threading
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
    one seed DFS on the host, then the hybrid split of the wave's queries
    over both chains (split_wave), or, under PRIBLAST_HYBRID=0 or where
    PRIBLAST_HYBRID=auto finds no card, fewer than 4 threads or a wave the
    device chain alone wins, one winner-take-all choice
    (device_extend_wins)."""
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
# Each may be set from the environment (PRIBLAST_<NAME>); the hybrid split
# recalibrates both sides' rates from their walls after every wave.
HOST_PAIR_RATE = float(os.environ.get("PRIBLAST_HOST_PAIR_RATE", 2.011e5))
DEV_PAIR_RATE = float(os.environ.get("PRIBLAST_DEV_PAIR_RATE", 2.915e7))
DEV_HIT_RATE = float(os.environ.get("PRIBLAST_DEV_HIT_RATE", 5.845e5))
HIT_DENSITY = float(os.environ.get("PRIBLAST_HIT_DENSITY", 0.09855))
DEV_DISPATCH_S = float(os.environ.get("PRIBLAST_DEV_DISPATCH_S", 0.0614))

# measured rates (pairs/s) by side, updated after each wave by _calibrate;
# each side writes only its own key
_CAL = {"host": None, "dev": None}


def _host_rate(threads: int) -> float:
    return _CAL["host"] or (HOST_PAIR_RATE * max(threads, 1))


def _dev_rate(n_dev: int) -> float:
    if _CAL["dev"]:
        return _CAL["dev"]
    per_pair = 1.0 / DEV_PAIR_RATE + HIT_DENSITY / DEV_HIT_RATE
    return n_dev / per_pair


def device_extend_wins(n_pairs: int, threads: int, n_dev: int) -> bool:
    """Winner-take-all estimate: the device chain against the host chain
    for a wave of `n_pairs` candidate pairs. It picks the chain where the
    hybrid is off, and under PRIBLAST_HYBRID=auto a win of the device
    chain turns the hybrid off. The device side carries its fixed per-wave
    cost, so tiny waves stay on the host."""
    host_t = n_pairs / (HOST_PAIR_RATE * max(threads, 1))
    dev_t = (DEV_DISPATCH_S
             + n_pairs / (DEV_PAIR_RATE * n_dev)
             + n_pairs * HIT_DENSITY / (DEV_HIT_RATE * n_dev))
    return dev_t < host_t


def split_wave(pairs_by_q: dict, threads: int, n_dev: int):
    """LPT assignment of a wave's queries over the two chains: each query
    (descending pair count) goes to the side whose projected finish time
    stays lower. Returns (host_qids, dev_qids). The device side starts at
    its fixed per-wave cost, so small waves stay on the host. The analog
    of the reference's dynamic work stealing between heterogeneous ranks
    (src/rna_interaction_search.cpp:94-152)."""
    hr = _host_rate(threads)
    dr = _dev_rate(n_dev)
    t_h, t_d = 0.0, DEV_DISPATCH_S
    host_ids, dev_ids = [], []
    for qid in sorted(pairs_by_q, key=lambda q: (-pairs_by_q[q], q)):
        np_q = pairs_by_q[qid]
        if np_q <= 0:
            host_ids.append(qid)
            continue
        if t_h + np_q / hr <= t_d + np_q / dr:
            host_ids.append(qid)
            t_h += np_q / hr
        else:
            dev_ids.append(qid)
            t_d += np_q / dr
    return host_ids, dev_ids


def _calibrate(side: str, n_pairs: int, wall_s: float) -> None:
    """Update one side's measured rate (an EMA) after a wave."""
    if n_pairs <= 0 or wall_s <= 1e-3:
        return
    rate = n_pairs / wall_s
    _CAL[side] = rate if _CAL[side] is None else \
        0.5 * _CAL[side] + 0.5 * rate


def _wave_plan(order, lengths, max_nt: int = 4 << 20, max_q: int = 1024):
    """Split queries (descending-length order) into waves bounded by total
    nucleotides and count, so flat device buffers stay bounded."""
    wave: list[int] = []
    nt = 0
    for idx in order:
        if wave and (nt + lengths[idx] > max_nt or len(wave) >= max_q):
            yield wave
            wave, nt = [], 0
        wave.append(idx)
        nt += lengths[idx]
    if wave:
        yield wave


def _accessibility_batched(engine, seqs, lengths, idxs):
    """Device accessibility for the given query indices; returns
    {idx: (acc, cond)} float32 arrays of per-sequence length."""
    out = {}
    for group, bsz, padded in db_gpu.plan_batches(
            [lengths[i] for i in idxs]):
        codes = np.zeros((bsz, padded), np.uint8)
        lens = np.zeros(bsz, np.int32)
        sel = [idxs[g] for g in group]
        for bi, idx in enumerate(sel):
            codes[bi, : lengths[idx]] = alphabet.access_codes(seqs[idx])
            lens[bi] = lengths[idx]
        acc, cond = engine.run(codes, lens)
        for bi, idx in enumerate(sel):
            ln = lengths[idx]
            out[idx] = (np.ascontiguousarray(acc[bi, :ln]),
                        np.ascontiguousarray(cond[bi, :ln]))
    return out


def run_queries(p: RisParams, chunks, names, seqs, order, results, *,
                devices, threads: int | None = None) -> None:
    """Fill results[idx] with the formatted lines of every query idx in
    `order`: accessibility split over `devices` (one device or a list),
    then each wave's queries routed over the device chain (its device
    stages split over `devices`) and the host chain
    (device_extend_mode)."""
    from priblast_tpu_torch.accessibility.batched import BatchedRaccess
    from priblast_tpu_torch.search import pipeline as pl

    devices = dist.device_list(devices)
    engine = BatchedRaccess(p.maximal_span, p.min_accessible_length,
                            dtype=p.dtype, devices=devices)
    native.lib()
    threads = threads or min(32, os.cpu_count() or 1)
    lengths = [len(s) for s in seqs]
    mode = device_extend_mode()
    dbpack = None
    done_q, t_start = 0, time.perf_counter()
    for wi, wave in enumerate(_wave_plan(order, lengths)):
        with prof.device_trace(f"ris_wave{wi}"):
            with prof.stage("ris.accessibility", devices):
                accs = _accessibility_batched(engine, seqs, lengths, wave)
            queries = []
            for idx in wave:
                q_enc = alphabet.encode_query(seqs[idx], p.repeat_flag)
                queries.append((q_enc, native.sa_build(q_enc), *accs[idx]))
            split = route(p, chunks, queries, mode, devices, threads)
            if split[1] and dbpack is None:
                dbpack = pl.DbPack(chunks, devices=devices)
            found = _search_wave(p, chunks, [names[i] for i in wave],
                                 queries, split, dbpack, devices, threads)
        for qid, lines in found.items():
            results[wave[qid]] = lines
        done_q += len(wave)
        if os.environ.get("PRIBLAST_PROGRESS"):
            el = max(time.perf_counter() - t_start, 1e-9)
            print(f"[ris] {done_q} queries, {el:.0f}s ({done_q / el:.3f} "
                  "q/s)", file=sys.stderr, flush=True)


def route(p, chunks, queries, mode: str, devices, threads: int):
    """Which chain searches each query of a wave. Returns (host qids,
    device qids, the seed candidates or None, pairs per qid); in `auto` the
    host seeds the wave once, and the device chain reuses the candidates
    of its queries. The device side's rate counts the distinct devices of
    `devices` (a card listed twice, as two shards on one card, is one
    card's rate), as the JAX package counts its mesh, which never holds a
    device twice."""
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
    dev_wins = device_extend_wins(sum(pairs_by_q.values()), threads, n_dev)
    hyb = os.environ.get("PRIBLAST_HYBRID", "auto").lower()
    if hyb == "auto":
        # the hybrid needs a card, and spare cores: on a host of few
        # threads the host chain starves the device chain's own host work.
        # Where the device chain alone wins, the host side's threads take
        # the cores its host stages (mid, the overflow re-runs, finish)
        # need, and the hybrid ran slower than the device chain alone
        # (chip_smoke.py [hybrid] against [main])
        has_card = any(dev.type == "cuda" for dev in devices)
        hyb = "1" if has_card and threads >= 4 and not dev_wins else "0"
    if hyb in ("0", "false"):
        if dev_wins:
            return [], every, cands, pairs_by_q
        return every, [], cands, pairs_by_q
    host_qids, dev_qids = split_wave(pairs_by_q, threads, n_dev)
    return host_qids, dev_qids, cands, pairs_by_q


def _search_wave(p, chunks, q_names, queries, split, dbpack, devices,
                 threads: int) -> dict[int, list[str]]:
    """Search one wave's queries on the chains `split` (route's result)
    assigns them. Returns {qid: formatted lines}. With queries on both sides
    the device chain runs on its own thread, on half the host threads,
    while the host chain runs on `threads`; each side calibrates its rate
    from its own wall. An exception on the device side is re-raised here
    once the host side is done: its queries are not searched again."""
    from priblast_tpu_torch.models.ris import format_hits
    from priblast_tpu_torch.search import pipeline as pl

    host_qids, dev_qids, cands, pairs_by_q = split
    found: dict[int, list[str]] = {}   # each side adds its own qids

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

    def device_side():
        t0 = time.perf_counter()
        qpack = pl.QueryPack([q[0] for q in queries], [q[2] for q in queries],
                             [q[3] for q in queries], [q[1] for q in queries],
                             devices=devices)
        dev_set = set(dev_qids)
        stream, finished = pl.search_all(
            p, chunks, queries, qpack, dbpack, devices=devices,
            threads=max(1, threads // 2) if host_qids else threads,
            dtype=p.dtype,
            cands=None if cands is None else
            [g for g in cands if g[0][0] in dev_set])
        with prof.stage("ris.format"):
            per_query: dict[int, list[str]] = {qid: [] for qid in dev_qids}
            for (qid, cid, _lo, _hi), res in zip(stream.groups, finished):
                per_query[qid].extend(format_hits(
                    p, res, chunks[cid], q_names[qid], q_length(qid)))
        found.update(per_query)
        _calibrate("dev", sum(pairs_by_q.get(q, 0) for q in dev_qids),
                   time.perf_counter() - t0)

    if not host_qids:
        device_side()
        return found
    dev_exc: list[BaseException] = []
    dev_thread = None
    if dev_qids:
        def run_device():
            try:
                device_side()
            except BaseException as e:  # re-raised by the calling thread
                dev_exc.append(e)

        dev_thread = threading.Thread(target=run_device,
                                      name="ris-device-chain")
        dev_thread.start()
    try:
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(threads) as ex:
            futs = {ex.submit(host_search, qid): qid for qid in host_qids}
            for f in cf.as_completed(futs):
                found[futs[f]] = f.result()
        _calibrate("host", sum(pairs_by_q.get(q, 0) for q in host_qids),
                   time.perf_counter() - t0)
    finally:
        if dev_thread is not None:
            dev_thread.join()
    if dev_exc:
        raise dev_exc[0]
    return found
