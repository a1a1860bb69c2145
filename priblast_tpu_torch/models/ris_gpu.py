"""Device path of the ris step.

Per wave of queries: accessibility runs on the device in length-bucketed
batches (the per-query hot DP, reference: src/rna_interaction_search.cpp:175),
then the staged cross-query search pipeline (search/pipeline.py) extends
every (query, chunk) hit stream with the device ungapped and gapped stages
— host threads run the seed / dedup / finish stages. Hit semantics are
identical to the exact engine; energies carry the device dtype's
accumulation noise (use --engine exact for byte parity).

A failure on the device is not retried on the host: it ends the run.
"""

from __future__ import annotations

import os

import numpy as np

from priblast_tpu_torch.models import db_gpu
from priblast_tpu_torch.ops import native
from priblast_tpu_torch.utils import alphabet
from priblast_tpu_torch.utils import profiling as prof
from priblast_tpu_torch.utils.params import RisParams


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
                device, threads: int | None = None) -> None:
    """Fill results[idx] with the formatted lines of every query idx in
    `order`, running accessibility and both extensions on `device`."""
    from priblast_tpu_torch.accessibility.batched import BatchedRaccess
    from priblast_tpu_torch.search import pipeline as pl

    engine = BatchedRaccess(p.maximal_span, p.min_accessible_length,
                            dtype=p.dtype, device=device)
    native.lib()
    threads = threads or min(32, os.cpu_count() or 1)
    lengths = [len(s) for s in seqs]
    dbpack = pl.DbPack(chunks, device=device)
    for wi, wave in enumerate(_wave_plan(order, lengths)):
        with prof.device_trace(f"ris_wave{wi}"):
            _run_wave(p, chunks, names, seqs, lengths, wave, engine, dbpack,
                      results, device, threads)


def _run_wave(p, chunks, names, seqs, lengths, wave, engine, dbpack,
              results, device, threads: int) -> None:
    from priblast_tpu_torch.models.ris import format_hits
    from priblast_tpu_torch.search import pipeline as pl

    with prof.stage("ris.accessibility", device):
        accs = _accessibility_batched(engine, seqs, lengths, wave)
    queries = []
    for idx in wave:
        q_enc = alphabet.encode_query(seqs[idx], p.repeat_flag)
        q_acc, q_cond = accs[idx]
        queries.append((q_enc, native.sa_build(q_enc), q_acc, q_cond))
    qpack = pl.QueryPack([q[0] for q in queries], [q[2] for q in queries],
                         [q[3] for q in queries], device=device)
    stream, finished = pl.search_all(p, chunks, queries, qpack, dbpack,
                                     device=device, threads=threads,
                                     dtype=p.dtype)
    with prof.stage("ris.format"):
        per_query: dict[int, list[str]] = {idx: [] for idx in wave}
        for (qid, cid, _lo, _hi), res in zip(stream.groups, finished):
            q_enc = queries[qid][0]
            q_length = int(np.count_nonzero((q_enc >= 2) & (q_enc <= 5)))
            per_query[wave[qid]].extend(format_hits(
                p, res, chunks[cid], names[wave[qid]], q_length))
        for idx in wave:
            results[idx] = per_query[idx]
