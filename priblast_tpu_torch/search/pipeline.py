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
                 direction)
  host   stage 5: vectorized base-pair assembly + per-group finish
         (dangles, bp sort, final sort + dedup)

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
from dataclasses import dataclass

import numpy as np
import torch

from priblast_tpu_torch.ops import native
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


class QueryPack:
    """Flat device buffers for a set of queries: encoded sequences (int64
    codes), float32 accessibility / conditional accessibility, and the
    queries' suffix arrays (int64, no pad, bases `sa_base`), which the
    fused stage (search/fused.py) expands from."""

    def __init__(self, q_encs, q_accs, q_conds, q_sas, *, device):
        enc, self.enc_base = _pack_regions(q_encs, np.int64)
        acc, self.acc_base = _pack_regions(q_accs, np.float32)
        cond, cond_base = _pack_regions(q_conds, np.float32)
        assert np.array_equal(self.acc_base, cond_base)
        self.bufs = tuple(torch.as_tensor(x, device=device)
                          for x in (enc, acc, cond))
        sa, self.sa_base = _pack_regions(q_sas, np.int64, pad=0)
        self.sa = torch.as_tensor(sa, device=device)


class DbPack:
    """Flat device buffers for all database chunks: sequences and
    accessibilities; the chunks' suffix arrays (bases `sa_base`); and dense
    position -> owning-sequence maps on the `seq_base` bases (pos_sid; pos_ls
    = the sequence's length + start position; pos_aoff / pos_coff = the
    absolute offsets of its accessibility arrays), which replace the
    reference's binary search over start positions
    (src/seed_search.cpp:101-141) with one read per field."""

    def __init__(self, chunks, *, device):
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
        self.bufs = tuple(torch.as_tensor(x, device=device)
                          for x in (seq, acc, cond))
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
        self.sa = torch.as_tensor(sa, device=device)
        for k, arrs in maps.items():
            flat, base = _pack_regions(arrs, np.int64)
            assert np.array_equal(base, self.seq_base)
            setattr(self, f"pos_{k}", torch.as_tensor(flat, device=device))


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


def _map_groups(fn, groups, threads: int):
    if threads > 1 and len(groups) > 1:
        with cf.ThreadPoolExecutor(threads) as ex:
            return list(ex.map(fn, groups))
    return [fn(g) for g in groups]


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
    _free, total = torch.cuda.mem_get_info(device)
    cap = lo
    while cap * 2 <= hi and bytes_per_item * cap * 2 <= total * frac:
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

    parts = _map_groups(one, stream.groups, threads)
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


def gapped_stage(stream: HitStream, seed_bps: dict, qpack: QueryPack,
                 dbpack: DbPack, chunks, queries, p, *, device,
                 max_ext: int = 32, dtype: str = "float32"):
    """Device gapped extension + traceback over the whole stream; assembles
    the final per-hit base-pair arrays (seed + left + right tracebacks, in
    reference push order). Returns bp arrays dict; updates stream in place.

    Hits whose extension outruns max_ext diagonals are flagged overflow by
    the device sweep and re-run from their pre-extension state on the
    exact host engine (a few % of hits at the default max_ext=32).
    """
    from priblast_tpu_torch.search.gapped import gapped_extend_flat_batch

    n = len(stream)
    if n == 0:
        return dict(bp_off=np.zeros(1, np.int64),
                    bp_q=np.zeros(0, np.int32), bp_db=np.zeros(0, np.int32))
    soa = stream.soa
    # device bytes per hit of one batch: the hit columns, both directions'
    # results and traceback lists, and their stacks (the kernel keeps its
    # working set in shared memory)
    item = 8 if dtype == "float64" else 4
    per_hit = 256 + 6 * item + 32 * (max_ext // 2 + 1)
    cap = _batch_cap(device, per_hit, 0.25, 4096, 1 << 17)
    gparts, bparts, oparts = [], [], []
    for o in range(0, n, cap):
        sub = {k: soa[k][o:o + cap] for k in (*STREAM_KEYS, *_BASE_KEYS)}
        g, b, ov = gapped_extend_flat_batch(
            sub, qpack.bufs, dbpack.bufs, d=p.min_accessible_length,
            dropout=p.drop_out_length_w_gap, min_helix=p.min_helix_length,
            max_ext=max_ext, dtype=dtype, device=device)
        gparts.append(g)
        bparts.append(b)
        oparts.append(ov)
    for k in STREAM_KEYS:
        soa[k] = np.concatenate([g[k] for g in gparts])
    overflow = np.concatenate(oparts)
    bp = {k: np.concatenate([b[k] for b in bparts])
          for k in ("n0", "q0", "db0", "n1", "q1", "db1")}

    if overflow.any():
        _overflow_fallback(stream, bp, overflow, chunks, queries, p)

    # ---- vectorized assembly: per hit, seed bps then left then right
    n_seed = np.diff(seed_bps["bp_off"]).astype(np.int64)
    total = n_seed + bp["n0"] + bp["n1"]
    bp_off = np.zeros(n + 1, np.int64)
    np.cumsum(total, out=bp_off[1:])
    bp_q = np.empty(bp_off[-1], np.int32)
    bp_db = np.empty(bp_off[-1], np.int32)

    def scatter(counts, start_within, src_q, src_db):
        # destination indices for ragged per-hit segments
        if len(src_q) == 0:
            return
        dst = (np.repeat(bp_off[:-1] + start_within, counts)
               + _ragged_arange(counts))
        bp_q[dst] = src_q
        bp_db[dst] = src_db

    scatter(n_seed, np.zeros(n, np.int64), seed_bps["bp_q"],
            seed_bps["bp_db"])
    scatter(bp["n0"], n_seed, bp["q0"], bp["db0"])
    scatter(bp["n1"], n_seed + bp["n0"], bp["q1"], bp["db1"])
    return dict(bp_off=bp_off, bp_q=bp_q, bp_db=bp_db)


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0-1, 0..c1-1, ...] for per-segment counts."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(counts)
    out = np.arange(total, dtype=np.int64)
    out -= np.repeat(ends - counts, counts)
    return out


def _overflow_fallback(stream: HitStream, bp: dict, overflow: np.ndarray,
                       chunks, queries, p) -> None:
    """Extension outran the device cap — exact host-engine fallback from the
    pre-extension state, patched into the stream and bp dict. Base-pair
    segments are rebuilt in ONE split/replace/concat pass, so the cost is
    O(total bps), independent of the overflow count."""
    soa = stream.soa
    repl: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    for qid, cid, lo, hi in stream.groups:
        idx = lo + np.nonzero(overflow[lo:hi])[0]
        if len(idx) == 0:
            continue
        q_enc, _q_sa, q_acc, q_cond = queries[qid]
        sub = {k: soa[f"pre_{k}"][idx] for k in STREAM_KEYS}
        ref = native.gapped_extend(q_enc, q_acc, q_cond, chunks[cid], p, sub)
        for out_i, src_i in enumerate(idx):
            for k in STREAM_KEYS:
                soa[k][src_i] = ref[k][out_i]
            blo, bhi = ref["bp_off"][out_i], ref["bp_off"][out_i + 1]
            repl[int(src_i)] = (ref["bp_q"][blo:bhi], ref["bp_db"][blo:bhi])
    if not repl:
        return
    # the host engine emits left+right bps contiguously; only the
    # concatenation order matters downstream, so the replacement lands in
    # the "left" segment and the right one empties
    seg_q = np.split(bp["q0"], np.cumsum(bp["n0"])[:-1])
    seg_db = np.split(bp["db0"], np.cumsum(bp["n0"])[:-1])
    seg_q1 = np.split(bp["q1"], np.cumsum(bp["n1"])[:-1])
    seg_db1 = np.split(bp["db1"], np.cumsum(bp["n1"])[:-1])
    empty = np.zeros(0, np.int32)
    n0 = bp["n0"].copy()
    n1 = bp["n1"].copy()
    for hit, (q, db) in repl.items():
        seg_q[hit], seg_db[hit] = q, db
        seg_q1[hit], seg_db1[hit] = empty, empty
        n0[hit] = len(q)
        n1[hit] = 0
    bp["n0"], bp["n1"] = n0, n1
    bp["q0"] = np.concatenate(seg_q)
    bp["db0"] = np.concatenate(seg_db)
    bp["q1"] = np.concatenate(seg_q1)
    bp["db1"] = np.concatenate(seg_db1)


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

    return _map_groups(one, stream.groups, threads)


def search_all(p, chunks, queries, qpack: QueryPack, dbpack: DbPack, *,
               device, threads: int = 1, max_ext: int = 32,
               dtype: str = "float32"):
    """The search chain over every (query, chunk) pair: host seed DFS, then
    expansion, ungapped extension and threshold on the device
    (search/fused.py), then finish_search. Returns (stream, results) where
    results is the per-group finished SoA list aligned with stream.groups.
    queries: list of (q_enc, q_sa, q_acc, q_cond)."""
    from priblast_tpu_torch.search import fused, seed

    with prof.stage("ris.seed"):
        cands = seed.seed_candidates(p, chunks, queries, threads)
    with prof.stage("ris.fused", device):
        stream = fused.fused_stage(p, cands, qpack, dbpack, device=device)
    return finish_search(stream, p, chunks, queries, qpack, dbpack,
                         device=device, threads=threads, max_ext=max_ext,
                         dtype=dtype)


def finish_search(stream: HitStream, p, chunks, queries, qpack: QueryPack,
                  dbpack: DbPack, *, device, threads: int = 1,
                  max_ext: int = 32, dtype: str = "float32"):
    """The chain after the threshold, on a post-threshold stream: the host
    mid stage, the device gapped extension and the host finish. Returns
    (stream, results) as search_all."""
    with prof.stage("ris.mid"):
        stream, seed_bps = mid_stage(stream, queries, chunks, p, threads)
        _hit_bases(stream, qpack, dbpack)
        # keep pre-extension state for the overflow fallback
        for k in STREAM_KEYS:
            stream.soa[f"pre_{k}"] = stream.soa[k].copy()
    with prof.stage("ris.gapped", device):
        bps = gapped_stage(stream, seed_bps, qpack, dbpack, chunks, queries,
                           p, device=device, max_ext=max_ext, dtype=dtype)
    with prof.stage("ris.finish"):
        results = finish_stage(stream, bps, queries, chunks, p, threads)
    return stream, results
