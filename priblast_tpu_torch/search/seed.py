"""Host seed search for the fused path: the DFS over paired suffix-array
intervals (native C++, reference src/seed_search.cpp:153-230), per
(query, chunk) pair on the thread pool. Its candidates are expanded into
hits on the device by search/fused.py."""

from __future__ import annotations

from priblast_tpu_torch.ops import native
from priblast_tpu_torch.search.pipeline import _map_groups


def seed_candidates(p, chunks, queries, threads: int = 1):
    """Seed candidates (native `search_chunk(..., stage=4)`) for every
    (query, chunk) pair, query-major. Returns a list of ((qid, cid),
    candidates) where candidates packs each SA interval pair into hit
    fields: q_sp/db_sp = the query interval, q_len/db_len = the db
    interval, dbseq_id = the seed length, hyb_e = its hybrid energy.
    queries: list of (q_enc, q_sa, q_acc, q_cond)."""
    pairs = [(qid, cid) for qid in range(len(queries))
             for cid in range(len(chunks))]

    def one(pair):
        qid, cid = pair
        q_enc, q_sa, q_acc, q_cond = queries[qid]
        return native.search_chunk(q_enc, q_sa, q_acc, q_cond, chunks[cid],
                                   p, stage=4)

    return list(zip(pairs, _map_groups(one, pairs, threads)))
