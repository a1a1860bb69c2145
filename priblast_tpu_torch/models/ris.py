"""RNA interaction search pipeline (the reference's `ris` step;
src/rna_interaction_search.cpp:61-92).

Per query: accessibility DP + suffix array, then for every database page the
kernel chain — seed search, interaction-energy expansion, ungapped
extension, dedup, gapped extension, dedup — and CSV emission. Queries run
in descending-length order; the output lines are emitted in exactly the
order the single-threaded reference produces (query order x page order x
hit order), so predictions.txt is byte-identical with --engine exact.
"""

from __future__ import annotations

import concurrent.futures as cf
import os

import numpy as np

from priblast_tpu_torch.ops import native
from priblast_tpu_torch.utils import alphabet, fasta, store
from priblast_tpu_torch.utils import profiling as prof
from priblast_tpu_torch.utils.params import RisParams


def format_hits(p: RisParams, res: dict, chunk: store.DbChunk, q_name: str,
                q_length: int) -> list[str]:
    """One CSV line per hit (reference: src/rna_interaction_search.cpp:322-369).
    db coordinates are flipped back to the original 5'->3' orientation.
    "%g" goes through the same C printf as the reference, so the bytes are
    identical to its per-field output."""
    n = len(res["q_sp"])
    if n == 0:
        return []
    sid = np.asarray(res["dbseq_id"], np.int64)
    rep_len = chunk.seq_length_rep[sid]
    start_pos = chunk.start_pos[sid].astype(np.int64)
    stored_len = chunk.seq_sizes[sid].astype(np.int64)
    names = np.asarray(chunk.names, dtype=object)[sid]

    def g(a):
        return ["%g" % v for v in np.asarray(a, np.float64).tolist()]

    def dstr(a):
        return np.char.mod("%d", np.asarray(a, np.int64))

    bp_off = np.asarray(res["bp_off"], np.int64)
    b0, b1 = bp_off[:-1], bp_off[1:]
    prefix = f"{q_name},{q_length},"
    acc_s = g(res["acc_e"])
    hyb_s = g(res["hyb_e"])
    e_s = g(res["energy"])
    bq = np.asarray(res["bp_q"], np.int64)
    bdb = np.asarray(res["bp_db"], np.int64)
    if p.output_style == 1:
        # per-base-pair lists: format the flat bp arrays once, join ragged
        flip = np.repeat(stored_len - 1 + start_pos, (b1 - b0))
        frags = np.char.add(np.char.add(np.char.add(np.char.add(
            "(", dstr(bq)), ":"), dstr(flip - bdb)), ") ").tolist()
        return [f"{prefix}{nm},{rl},{a},{h},{e},{''.join(frags[x:y])}"
                for nm, rl, a, h, e, x, y in zip(
                    names.tolist(), rep_len.tolist(), acc_s, hyb_s, e_s,
                    b0.tolist(), b1.tolist())]
    flip = stored_len - 1 + start_pos
    return [f"{prefix}{nm},{rl},{a},{h},{e},({p1}-{p2}:{d1}-{d2}) "
            for nm, rl, a, h, e, p1, p2, d1, d2 in zip(
                names.tolist(), rep_len.tolist(), acc_s, hyb_s, e_s,
                bq[b0].tolist(), bq[b1 - 1].tolist(),
                (flip - bdb[b0]).tolist(), (flip - bdb[b1 - 1]).tolist())]


def header(p: RisParams) -> str:
    """Output header (reference: src/rna_interaction_search.cpp:445-462)."""
    h = "RIblast ris result\n"
    h += ("input:%s,database:%s,RepeatFlag:%d,MaximalSpan:%d,"
          "MinAccessibleLength:%d,MaxSeedLength:%d,"
          "InteractionEnergyThreshold:%g,HybridEnergyThreshold:%g,"
          "FinalThreshold:%g,DropOutLengthWoGap:%d,DropOutLengthWGap:%d\n"
          ) % (p.input, p.db_name, p.repeat_flag, p.maximal_span,
               p.min_accessible_length, p.max_seed_length,
               p.interaction_energy_threshold, p.hybrid_energy_threshold,
               p.final_threshold, p.drop_out_length_wo_gap,
               p.drop_out_length_w_gap)
    h += ("Id,Query name, Query Length, Target name, Target Length, "
          "Accessibility Energy, Hybridization Energy, Interaction Energy, "
          "BasePair\n")
    return h


def search_query(p: RisParams, chunks: list[store.DbChunk], name: str,
                 seq: str) -> list[str]:
    """Exact host chain for one query across all database pages."""
    q_acc, q_cond = native.raccess(
        alphabet.access_codes(seq), p.maximal_span, p.min_accessible_length)
    q_enc = alphabet.encode_query(seq, p.repeat_flag)
    q_sa = native.sa_build(q_enc)
    q_length = int(np.count_nonzero((q_enc >= 2) & (q_enc <= 5)))

    lines: list[str] = []
    for chunk in chunks:
        res = native.search_chunk(q_enc, q_sa, q_acc, q_cond, chunk, p)
        lines.extend(format_hits(p, res, chunk, name, q_length))
    return lines


def run(p: RisParams, threads: int | None = None, devices=None) -> None:
    """The ris step. `devices`: the gpu engine's torch devices (one or a
    list), in place of every card this process owns (`--device cuda`) or
    the CPU (`--device cpu`)."""
    from priblast_tpu_torch.parallel import multihost

    pidx, pcount = multihost.init_from_env()
    try:
        with prof.command("ris"):
            _run(p, threads, pidx, pcount, devices)
    finally:
        multihost.shutdown()


def _run(p: RisParams, threads: int | None, pidx: int, pcount: int,
         devices=None) -> None:
    from priblast_tpu_torch.parallel import dist, multihost

    if p.engine != "gpu":
        devices = None
    elif devices is None:
        devices = dist.local_devices(p.device, pidx, pcount)
    else:
        devices = dist.device_list(devices)
    p.load_db_params()
    names, seqs = fasta.read_fasta(p.input)
    with prof.stage("ris.load"):
        chunks = store.load_chunks(p.db_name, p.hash_size)
    prof.count("ris.db_pages", len(chunks))
    prof.count("ris.db_nt", sum(int(c.seq_sizes.sum()) for c in chunks))
    order = [int(i) for i in native.argsort_desc([len(s) for s in seqs])]
    if pcount > 1:
        # this process's query shard by the -a distribution strategy
        # (reference: src/fastafile_reader.cpp:135-314)
        mine = set(multihost.partition_for(
            p.algorithm, [len(s) for s in seqs], pcount)[pidx])
        my_order = [i for i in order if i in mine]
    else:
        my_order = order
    threads = threads or min(32, os.cpu_count() or 1)
    results: list[list[str] | None] = [None] * len(seqs)

    if devices is not None:
        from priblast_tpu_torch.models import ris_gpu

        ris_gpu.run_queries(p, chunks, names, seqs, my_order, results,
                            devices=devices, threads=threads)
    elif threads > 1 and len(my_order) > 1:
        with cf.ThreadPoolExecutor(threads) as ex:
            futs = {ex.submit(search_query, p, chunks, names[i], seqs[i]): i
                    for i in my_order}
            for f in cf.as_completed(futs):
                results[futs[f]] = f.result()
    else:
        for i in my_order:
            results[i] = search_query(p, chunks, names[i], seqs[i])

    prof.maybe_report()
    if pcount > 1:
        # part file + barrier + ordered merge on process 0 (replaces the
        # reference's completion-order ring,
        # src/rna_interaction_search.cpp:202-230)
        multihost.write_ris_part(
            multihost.part_path(p.output, p.tmp_path, pidx),
            {i: results[i] or [] for i in my_order})
        multihost.barrier("ris_parts")
        if pidx != 0:
            return
        parts = [multihost.part_path(p.output, p.tmp_path, q)
                 for q in range(pcount)]
        merged = multihost.read_ris_parts(parts)
        results = [merged.get(i) for i in range(len(seqs))]
        for part in parts:
            part.unlink()

    with open(p.output, "w") as f:
        f.write(header(p))
        count = 0
        for i in order:
            for line in results[i] or []:
                f.write("%d,%s\n" % (count, line))
                count += 1
