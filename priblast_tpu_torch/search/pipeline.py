"""Cross-query staged search pipeline for the ris step.

The reference's per-(query, db-page) kernel chain
(src/rna_interaction_search.cpp:130-200) is restructured into stages that
batch hits ACROSS every (query, chunk) pair, so the device stages see a
few large batches instead of thousands of small calls:

  host   stage 1: seed DFS per (query, chunk) (native C++, thread pool)
  device stage 2: seed expansion, ungapped extension (one CUDA kernel, a
                 thread per hit) and the interaction-energy threshold, per
                 block of candidate pairs (search/fused.py) -> one global
                 hit stream tagged by group
  host   stage 3: per-group sort + interaction-threshold dedup + seed bps
  device stage 4: gapped extension DP + traceback (one CUDA kernel per
                 direction); the hits past its max_ext re-run on the exact
                 host engine, on threads beside the next hit batches
  host   stage 5: vectorized base-pair assembly + per-group finish
         (dangles, bp sort, final sort + dedup)

The device stages take a list of devices (parallel/dist.py): each block
of pairs and each batch of hits is split over them, and the packs hold one
copy per distinct device.

Flat buffers: every query's encoded sequence / accessibility arrays and
every chunk's sequence / accessibility arrays are packed into single
device tensors with one zero pad entry before each region (the pad
reproduces the reference's left-boundary stop, since its encodings already
carry a trailing sentinel). Hits carry base offsets into those buffers;
hit coordinates stay query-/chunk-local, as in the reference.

seed_stage -> ungapped_stage -> threshold_stage compute the same stream
in separate steps (native stage-1 hits, the kernel over the whole stream,
a host threshold): the tests and chip_smoke.py hold the fused stage
against them.

Hit semantics are identical to the exact engine; energies carry the device
dtype's accumulation noise.
"""

from __future__ import annotations

import concurrent.futures as cf
import copy
import time
from dataclasses import dataclass

import numpy as np
import torch

from priblast_tpu_torch.ops import native
from priblast_tpu_torch.parallel import dist
from priblast_tpu_torch.utils import profiling as prof


def _pack_regions(arrays, np_dtype, pad: int = 1, tail: int = 8):
    """Concatenate arrays into one flat buffer with `pad` zero entries
    before each region; returns (flat, bases int64[n])."""
    total = sum(len(a) for a in arrays) + pad * len(arrays) + tail
    flat = np.zeros(total, np_dtype)
    bases = np.zeros(len(arrays), np.int64)
    pos = 0
    for i, a in enumerate(arrays):
        pos += pad
        bases[i] = pos
        flat[pos: pos + len(a)] = a
        pos += len(a)
    return flat, bases


class OnDevices:
    """Host arrays put once on each distinct device of a list (a device
    repeated in the list shares its copy). The tensor attributes hold the
    first device's copy; `at(device)` gives a view of the object whose
    tensor attributes hold that device's."""

    def _place(self, host: dict, devices) -> None:
        """host: attribute -> numpy array, or tuple of numpy arrays."""
        def put(x, dev):
            if isinstance(x, tuple):
                return tuple(torch.as_tensor(a, device=dev) for a in x)
            return torch.as_tensor(x, device=dev)

        self.devices = dist.device_list(devices)
        self._copies = {dev: {k: put(v, dev) for k, v in host.items()}
                        for dev in dist.distinct(self.devices)}
        self.__dict__.update(self._copies[self.devices[0]])

    def at(self, device):
        view = copy.copy(self)
        view.__dict__.update(self._copies[dist.device_list(device)[0]])
        return view

    def device_bytes(self) -> int:
        """The bytes of the copies, summed over the distinct devices."""
        return sum(t.nbytes for put in self._copies.values()
                   for v in put.values()
                   for t in (v if isinstance(v, tuple) else (v,)))


class QueryPack(OnDevices):
    """Flat device buffers for a set of queries: encoded sequences (int64
    codes), float32 accessibility / conditional accessibility, and the
    queries' suffix arrays (int64, no pad, bases `sa_base`), which the
    fused stage (search/fused.py) expands from; one copy per distinct
    device of `devices` (one device or a list)."""

    def __init__(self, q_encs, q_accs, q_conds, q_sas, *, devices):
        enc, self.enc_base = _pack_regions(q_encs, np.int64)
        acc, self.acc_base = _pack_regions(q_accs, np.float32)
        cond, cond_base = _pack_regions(q_conds, np.float32)
        assert np.array_equal(self.acc_base, cond_base)
        sa, self.sa_base = _pack_regions(q_sas, np.int64, pad=0)
        self._place({"bufs": (enc, acc, cond), "sa": sa}, devices)


class DbPack(OnDevices):
    """Flat device buffers for all database chunks: sequences and
    accessibilities; the chunks' suffix arrays (bases `sa_base`); and dense
    position -> owning-sequence maps on the `seq_base` bases (pos_sid; pos_ls
    = the sequence's length + start position; pos_aoff / pos_coff = the
    absolute offsets of its accessibility arrays), which replace the
    reference's binary search over start positions
    (src/seed_search.cpp:101-141) with one read per field; one copy per
    distinct device of `devices` (one device or a list)."""

    def __init__(self, chunks, *, devices):
        seq, self.seq_base = _pack_regions([c.seqs for c in chunks],
                                           np.int64)
        acc, acc_base = _pack_regions([c.acc for c in chunks], np.float32,
                                      pad=0)
        cond, cond_base = _pack_regions([c.cond for c in chunks],
                                        np.float32, pad=0)
        # absolute per-(chunk, seq) accessibility offsets for host lookups
        self.abs_acc_off = [acc_base[ci] + c.acc_off
                            for ci, c in enumerate(chunks)]
        self.abs_cond_off = [cond_base[ci] + c.cond_off
                             for ci, c in enumerate(chunks)]
        sa, self.sa_base = _pack_regions([c.suffix_array for c in chunks],
                                         np.int64, pad=0)
        maps = {k: [] for k in ("sid", "ls", "aoff", "coff")}
        for ci, c in enumerate(chunks):
            sid = np.searchsorted(c.start_pos, np.arange(len(c.seqs)),
                                  side="right") - 1
            sid = np.clip(sid, 0, c.n_seqs - 1)
            maps["sid"].append(sid)
            maps["ls"].append(c.seq_sizes[sid].astype(np.int64)
                              + c.start_pos[sid])
            maps["aoff"].append(self.abs_acc_off[ci][sid])
            maps["coff"].append(self.abs_cond_off[ci][sid])
        host = {"bufs": (seq, acc, cond), "sa": sa}
        for k, arrs in maps.items():
            flat, base = _pack_regions(arrs, np.int64)
            assert np.array_equal(base, self.seq_base)
            host[f"pos_{k}"] = flat
        self._place(host, devices)

    def pages(self, cids):
        """A view of the pack as the database of pages `cids` alone (page i
        of the view is page cids[i]), on the same device buffers: the
        search of a group of pages. The pack itself where `cids` is every
        page in order."""
        if list(cids) == list(range(len(self.seq_base))):
            return self
        view = copy.copy(self)
        view.seq_base = self.seq_base[cids]
        view.sa_base = self.sa_base[cids]
        view.abs_acc_off = [self.abs_acc_off[c] for c in cids]
        view.abs_cond_off = [self.abs_cond_off[c] for c in cids]
        return view


@dataclass
class HitStream:
    """Global struct-of-arrays hit stream plus its (query, chunk) grouping.

    groups: list of (qid, cid, lo, hi) half-open slices into the arrays;
    group order is qid-major then cid, matching the reference's output
    order (query loop x page loop, src/rna_interaction_search.cpp:185).
    """

    soa: dict
    groups: list

    def __len__(self) -> int:
        return len(self.soa["q_sp"]) if self.soa else 0


STREAM_KEYS = native.HIT_KEYS
_BASE_KEYS = ("qb", "qab", "dbb", "aoff", "coff")


def _concat_groups(parts, groups_meta):
    """parts: list of SoA dicts; groups_meta: list of (qid, cid)."""
    groups = []
    lo = 0
    for (qid, cid), part in zip(groups_meta, parts):
        n = len(part["q_sp"])
        groups.append((qid, cid, lo, lo + n))
        lo += n
    soa = {}
    for k in STREAM_KEYS:
        arrs = [np.asarray(part[k]) for part in parts]
        soa[k] = np.concatenate(arrs) if arrs else np.zeros(0, np.int32)
    return HitStream(soa, groups)


def _map_groups(fn, groups, threads: int, name: str | None = None):
    """[fn(g) for g in groups], on a pool of `threads` host threads. Given
    a stage `name`, each call is the span <name>.group, and the counter
    <name>.pool_s adds the map's wall time times the threads it can keep
    busy, so the spans' sum over the counter is the pool's busy share."""
    one = fn
    if name is not None:
        def one(g):
            with prof.stage(f"{name}.group"):
                return fn(g)

    t0 = time.perf_counter()
    if threads > 1 and len(groups) > 1:
        with cf.ThreadPoolExecutor(threads) as ex:
            out = list(ex.map(one, groups))
        workers = min(threads, len(groups))
    else:
        out = [one(g) for g in groups]
        workers = 1
    if name is not None:
        prof.count(f"{name}.pool_s", (time.perf_counter() - t0) * workers)
    return out


def seed_stage(p, chunks, queries, threads: int = 1) -> HitStream:
    """Stage-1 hits (seed + SA-interval expansion) for every (query, chunk)
    pair. queries: list of (q_enc, q_sa, q_acc, q_cond)."""
    pairs = [(qid, cid) for qid in range(len(queries))
             for cid in range(len(chunks))]

    def one(pair):
        qid, cid = pair
        q_enc, q_sa, q_acc, q_cond = queries[qid]
        return native.search_chunk(q_enc, q_sa, q_acc, q_cond, chunks[cid],
                                   p, stage=1)

    return _concat_groups(_map_groups(one, pairs, threads), pairs)


def _hit_bases(stream: HitStream, qpack: QueryPack, dbpack: DbPack) -> None:
    """Attach per-hit flat-buffer base offsets (qb/qab/dbb/aoff/coff)."""
    n = len(stream)
    soa = stream.soa
    for k in _BASE_KEYS:
        soa[k] = np.zeros(n, np.int64)
    for qid, cid, lo, hi in stream.groups:
        soa["qb"][lo:hi] = qpack.enc_base[qid]
        soa["qab"][lo:hi] = qpack.acc_base[qid]
        soa["dbb"][lo:hi] = dbpack.seq_base[cid]
        ids = soa["dbseq_id"][lo:hi]
        soa["aoff"][lo:hi] = dbpack.abs_acc_off[cid][ids]
        soa["coff"][lo:hi] = dbpack.abs_cond_off[cid][ids]


def _batch_cap(device, bytes_per_item: int, frac: float, lo: int,
               hi: int) -> int:
    """Largest power-of-two batch whose working set stays within `frac` of
    the card's memory, clamped to [lo, hi]; `lo` on the CPU. Batching only
    bounds memory: results do not depend on the cap."""
    if device.type != "cuda":
        return lo
    budget = dist.card_budget(device, frac)
    cap = lo
    while cap * 2 <= hi and bytes_per_item * cap * 2 <= budget:
        cap *= 2
    return cap


def ungapped_stage(stream: HitStream, qpack: QueryPack, dbpack: DbPack, p,
                   *, device) -> None:
    """Device ungapped extension over the whole stream, in place: the CUDA
    kernel on the card, its plain version on the CPU."""
    from priblast_tpu_torch.ops import ungapped_extend as uop

    n = len(stream)
    if n == 0:
        return
    soa = stream.soa
    qpack, dbpack = qpack.at(device), dbpack.at(device)
    cap = _batch_cap(device, 512, 0.05, 65536, 1 << 20)
    outs = {k: [] for k in ("q_sp", "db_sp", "q_len", "db_len",
                            "dbseq_start", "acc_e", "hyb_e", "energy")}
    for o in range(0, n, cap):
        sl = slice(o, min(n, o + cap))

        def put(k, dtype=torch.int64):
            return torch.as_tensor(soa[k][sl], device=device).to(dtype)

        res = uop.ungapped_extend(
            put("q_sp"), put("db_sp"), put("q_len"), put("dbseq_start"),
            put("acc_e", torch.float32), put("hyb_e", torch.float32),
            *(put(k) for k in _BASE_KEYS),
            qpack.bufs, dbpack.bufs,
            p.min_accessible_length, p.drop_out_length_wo_gap)
        for k in outs:
            v = res[k].cpu().numpy()
            outs[k].append(v if v.dtype == np.float32 else v.astype(np.int32))
    for k in outs:
        soa[k] = np.concatenate(outs[k])


def filter_stream(stream: HitStream, keep: np.ndarray) -> HitStream:
    """Keep a boolean-masked subset, preserving order and regrouping."""
    kept_cum = np.concatenate([[0], np.cumsum(keep)])
    groups = [(qid, cid, int(kept_cum[lo]), int(kept_cum[hi]))
              for qid, cid, lo, hi in stream.groups]
    soa = {k: v[keep] for k, v in stream.soa.items()}
    return HitStream(soa, groups)


def threshold_stage(stream: HitStream, p) -> HitStream:
    """Drop hits above the interaction-energy threshold before the host
    dedup. The reference flags these at the top of its redundancy scan
    (src/rna_interaction_search.cpp:389-391) and flagged hits never affect
    other hits' dedup decisions, so pre-filtering is semantics-preserving."""
    if len(stream) == 0:
        return stream
    # compared in float64, as the reference compares its double energies:
    # NumPy compares a float32 array with a Python float in float32,
    # against the threshold rounded to float32
    energy = stream.soa["energy"].astype(np.float64)
    return filter_stream(stream, energy <= p.interaction_energy_threshold)


def mid_stage(stream: HitStream, queries, chunks, p, threads: int = 1):
    """Per-group sort + interaction-threshold dedup + seed base pairs
    (native chain_mid). Returns (new stream, bp arrays dict)."""
    def one(group):
        qid, cid, lo, hi = group
        sub = {k: stream.soa[k][lo:hi] for k in STREAM_KEYS}
        return native.chain_mid(queries[qid][0], chunks[cid], p, sub)

    parts = _map_groups(one, stream.groups, threads, "ris.mid")
    meta = [(qid, cid) for qid, cid, _, _ in stream.groups]
    out = _concat_groups(parts, meta)
    bp_off = np.concatenate(
        [np.zeros(1, np.int64)]
        + [np.diff(part["bp_off"]) for part in parts]).cumsum()
    bps = dict(bp_off=bp_off.astype(np.int64),
               bp_q=np.concatenate([np.zeros(0, np.int32)]
                                   + [part["bp_q"] for part in parts]),
               bp_db=np.concatenate([np.zeros(0, np.int32)]
                                    + [part["bp_db"] for part in parts]))
    return out, bps


def gapped_cap(devices, max_ext: int = 32, dtype: str = "float32") -> int:
    """Hits per batch of the gapped stage: the largest power of two whose
    device bytes (the hit columns, both directions' results and traceback
    lists, and their stacks; the kernel keeps its working set in shared
    memory) stay within a quarter of every device's memory, 4096..2^17."""

    item = 8 if dtype == "float64" else 4
    per_hit = 256 + 6 * item + 32 * (max_ext // 2 + 1)
    return min(_batch_cap(dev, per_hit, 0.25, 4096, 1 << 17)
               for dev in dist.distinct(devices))


def gapped_stage(stream: HitStream, seed_bps: dict, qpack: QueryPack,
                 dbpack: DbPack, chunks, queries, p, *, devices,
                 threads: int = 1, max_ext: int = 32,
                 dtype: str = "float32"):
    """Device gapped extension + traceback over the whole stream; assembles
    the final per-hit base-pair arrays (seed + left + right tracebacks, in
    reference push order). Returns bp arrays dict; updates stream in place.
    Each batch of `gapped_cap` hits is split over `devices` (one device or
    a list; dist.split_rows), each part through both directions of the
    kernel on its device and thread, and the parts joined in order.

    Hits whose extension outruns max_ext diagonals are flagged overflow by
    the kernel and re-run from their pre-extension state on the exact host
    engine (OverflowFallback), each batch's on `threads` - 1 host threads
    while this thread runs the next batches. On chip_smoke.py's workload
    at max_ext = 32 that is 47,125 of 1,249,785 hits (3.8%), whose native
    calls took 4.5-5.5 s summed over the threads on the 8 cores of an
    H100's host.
    """
    from priblast_tpu_torch.search.gapped import gapped_extend_flat_batch

    n = len(stream)
    if n == 0:
        return dict(bp_off=np.zeros(1, np.int64),
                    bp_q=np.zeros(0, np.int32), bp_db=np.zeros(0, np.int32))
    soa = stream.soa
    devices = dist.device_list(devices)
    cap = gapped_cap(devices, max_ext, dtype)

    def part(dev, lo, hi):
        sub = {k: soa[k][lo:hi] for k in (*STREAM_KEYS, *_BASE_KEYS)}
        return gapped_extend_flat_batch(
            sub, qpack.at(dev).bufs, dbpack.at(dev).bufs,
            d=p.min_accessible_length, dropout=p.drop_out_length_w_gap,
            min_helix=p.min_helix_length, max_ext=max_ext, dtype=dtype,
            device=dev)

    gparts, bparts, oparts = [], [], []
    with OverflowFallback(stream, chunks, queries, p, threads) as fallback:
        for o in range(0, n, cap):
            rows = dist.split_rows(min(cap, n - o), len(devices))
            shards = [(dev, o + lo, o + hi)
                      for dev, (lo, hi) in zip(devices, rows) if hi > lo]
            for g, b, ov in dist.run_sharded(part, shards):
                gparts.append(g)
                bparts.append(b)
                oparts.append(ov)
            fallback.submit(np.concatenate(oparts[-len(shards):]), o)
        for k in STREAM_KEYS:
            soa[k] = np.concatenate([g[k] for g in gparts])
        bp = {k: np.concatenate([b[k] for b in bparts])
              for k in ("n0", "q0", "db0", "n1", "q1", "db1")}
        segments = fallback.patch([
            (np.diff(seed_bps["bp_off"]), seed_bps["bp_q"],
             seed_bps["bp_db"]),
            (bp["n0"], bp["q0"], bp["db0"]),
            (bp["n1"], bp["q1"], bp["db1"])])
    return assemble_bps(segments)


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0-1, 0..c1-1, ...] for per-segment counts."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(counts)
    out = np.arange(total, dtype=np.int64)
    out -= np.repeat(ends - counts, counts)
    return out


def assemble_bps(segments) -> dict:
    """The base-pair arrays (bp_off, bp_q, bp_db) of ragged per-hit
    segments [(counts[n], q, db), ...], each segment's pairs lying
    hit after hit: a hit's pairs are its segments' in list order."""
    counts = [np.asarray(c, np.int64) for c, _q, _db in segments]
    n = len(counts[0])
    bp_off = np.zeros(n + 1, np.int64)
    np.cumsum(sum(counts), out=bp_off[1:])
    bp_q = np.empty(bp_off[-1], np.int32)
    bp_db = np.empty(bp_off[-1], np.int32)
    start = bp_off[:-1].copy()
    for c, (_c, q, db) in zip(counts, segments):
        if len(q):
            dst = np.repeat(start, c) + _ragged_arange(c)
            bp_q[dst] = q
            bp_db[dst] = db
        start += c
    return dict(bp_off=bp_off, bp_q=bp_q, bp_db=bp_db)


class OverflowFallback:
    """The exact host engine for the hits whose extension outran the
    kernel's max_ext, from their pre-extension state (the stream's pre_*
    fields). `submit` queues the re-runs of one batch's flagged hits, one
    native call per (query, chunk) group the batch holds, on a pool of
    `threads` - 1 host threads (at least one; ctypes releases the GIL), so
    they run while the caller goes on with the next batches on the core
    left to it; each call is timed as the stage ris.gapped.rerun (summed
    over the threads). `patch` waits for
    them (ris.gapped.rerun_wait), then patches their results in, in
    submission order, with one vectorised pass (ris.gapped.patch) that
    builds no per-hit Python object. Results depend neither on `threads`
    nor on how the hits were cut into batches. Use it as a context
    manager: the pool is shut down on leaving it."""

    def __init__(self, stream: HitStream, chunks, queries, p,
                 threads: int = 1):
        self.stream, self.chunks, self.queries, self.p = (stream, chunks,
                                                          queries, p)
        self._his = np.asarray([hi for _q, _c, _lo, hi in stream.groups],
                               np.int64)
        self._idx, self._futs = [], []
        self.workers = max(1, threads - 1)
        self._pool = cf.ThreadPoolExecutor(self.workers)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._pool.shutdown(cancel_futures=True)

    def _rerun(self, qid, cid, idx):
        q_enc, _q_sa, q_acc, q_cond = self.queries[qid]
        sub = {k: self.stream.soa[f"pre_{k}"][idx] for k in STREAM_KEYS}
        with prof.stage("ris.gapped.rerun"):
            return native.gapped_extend(q_enc, q_acc, q_cond,
                                        self.chunks[cid], self.p, sub)

    def submit(self, overflow: np.ndarray, start: int = 0) -> None:
        """Queue the re-runs of the hits start .. start + len(overflow) - 1
        that `overflow` flags."""
        end = start + len(overflow)
        gi = int(np.searchsorted(self._his, start, side="right"))
        for qid, cid, lo, hi in self.stream.groups[gi:]:
            if lo >= end:
                break
            lo, hi = max(lo, start), min(hi, end)
            idx = lo + np.flatnonzero(overflow[lo - start: hi - start])
            if len(idx):
                self._idx.append(idx)
                self._futs.append(self._pool.submit(self._rerun, qid, cid,
                                                    idx))

    def patch(self, segments):
        """The stream's fields of every re-run hit patched in place.
        `segments` = [seed, left, right] as gapped_stage builds them
        (per-hit counts and the pairs, hit after hit). Returns [seed,
        host, left, right]: a re-run hit's device left and right pairs are
        dropped, and the host engine's (left and right contiguously, as it
        emits them) follow its seed pairs."""
        with prof.stage("ris.gapped.rerun_wait"):
            refs = [f.result() for f in self._futs]
        if not refs:
            return segments
        with prof.stage("ris.gapped.patch"):
            soa = self.stream.soa
            idx = np.concatenate(self._idx)
            for k in STREAM_KEYS:
                soa[k][idx] = np.concatenate([ref[k] for ref in refs])
            rerun = np.zeros(len(self.stream), bool)
            rerun[idx] = True
            n_host = np.zeros(len(rerun), np.int64)
            n_host[idx] = np.concatenate([np.diff(ref["bp_off"])
                                          for ref in refs])
            host = (n_host, np.concatenate([ref["bp_q"] for ref in refs]),
                    np.concatenate([ref["bp_db"] for ref in refs]))
            device = []
            for c, q, db in segments[1:]:
                keep = np.repeat(~rerun, c)
                device.append((np.where(rerun, 0, c), q[keep], db[keep]))
        return [segments[0], host, *device]


def finish_stage(stream: HitStream, bps: dict, queries, chunks, p,
                 threads: int = 1):
    """Per-group finish (dangles, bp sort, final sort + dedup). Returns a
    list of per-group SoA result dicts aligned with stream.groups."""
    def one(group):
        qid, cid, lo, hi = group
        sub = {k: stream.soa[k][lo:hi] for k in STREAM_KEYS}
        blo = bps["bp_off"][lo]
        bhi = bps["bp_off"][hi]
        off = bps["bp_off"][lo:hi + 1] - blo
        return native.chain_finish(queries[qid][0], chunks[cid], p, sub,
                                   off, bps["bp_q"][blo:bhi],
                                   bps["bp_db"][blo:bhi])

    return _map_groups(one, stream.groups, threads, "ris.finish")


def search_all(p, chunks, queries, qpack: QueryPack, dbpack: DbPack, *,
               devices, threads: int = 1, max_ext: int = 32,
               dtype: str = "float32", cands=None):
    """The search chain over every (query, chunk) pair: host seed DFS, then
    expansion, ungapped extension and threshold on the device
    (search/fused.py), then finish_search; the device stages split over
    `devices` (one device or a list). Returns (stream, results) where
    results is the per-group finished SoA list aligned with stream.groups.
    queries: list of (q_enc, q_sa, q_acc, q_cond). `cands`: the seed
    candidates, where the caller has already seeded (the ris router); then
    only their groups are searched, and the seed DFS does not run again."""
    from priblast_tpu_torch.search import fused, seed

    if cands is None:
        with prof.stage("ris.seed"):
            cands = seed.seed_candidates(p, chunks, queries, threads)
    with prof.stage("ris.fused", devices):
        stream = fused.fused_stage(p, cands, qpack, dbpack, devices=devices)
    return finish_search(stream, p, chunks, queries, qpack, dbpack,
                         devices=devices, threads=threads, max_ext=max_ext,
                         dtype=dtype)


def finish_search(stream: HitStream, p, chunks, queries, qpack: QueryPack,
                  dbpack: DbPack, *, devices, threads: int = 1,
                  max_ext: int = 32, dtype: str = "float32"):
    """The chain after the threshold, on a post-threshold stream: the host
    mid stage, the device gapped extension (split over `devices`) and the
    host finish. Returns (stream, results) as search_all."""
    with prof.stage("ris.mid"):
        stream, seed_bps = mid_stage(stream, queries, chunks, p, threads)
        _hit_bases(stream, qpack, dbpack)
        # keep pre-extension state for the overflow fallback
        for k in STREAM_KEYS:
            stream.soa[f"pre_{k}"] = stream.soa[k].copy()
    with prof.stage("ris.gapped", devices):
        bps = gapped_stage(stream, seed_bps, qpack, dbpack, chunks, queries,
                           p, devices=devices, threads=threads,
                           max_ext=max_ext, dtype=dtype)
    with prof.stage("ris.finish"):
        results = finish_stage(stream, bps, queries, chunks, p, threads)
    return stream, results
