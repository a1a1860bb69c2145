"""The port's search_all against the full native chain on the tiny
goldens, on the CPU, float64 device math: hit ids, extents and base pairs
exact, energies to 3e-4 (the ungapped stage keeps the reference's float32
steps), as tests/test_search_kernels.py:133-221 holds the JAX pipeline.
Both fronts: search_all's fused one (host seed DFS -> device expansion,
ungapped, threshold), and the staged oracle the fused stage is held to
(native stage-1 hits -> ungapped_stage -> threshold_stage); each then runs
finish_search (native mid -> device gapped -> native finish)."""

import dataclasses

import numpy as np
import pytest
import torch

# the port runs many small tensor ops here: one intra-op thread per test
# worker avoids oversubscribing the host under pytest-xdist
torch.set_num_threads(1)

from priblast_tpu_torch.ops import native
from priblast_tpu_torch.ops import ungapped_extend as ungapped_op
from priblast_tpu_torch.search import fused
from priblast_tpu_torch.search import pipeline as tpl
from priblast_tpu_torch.utils import profiling as prof
from test_torch_ungapped import build_staged

CPU = torch.device("cpu")
EXACT_KEYS = ("q_sp", "db_sp", "q_len", "db_len", "dbseq_start", "dbseq_id",
              "bp_q", "bp_db", "bp_off")


@pytest.fixture(scope="module")
def staged(tmp_path_factory, data_dir):
    return build_staged(tmp_path_factory.mktemp("torch_pipeline"), data_dir)


@pytest.fixture(scope="module")
def paged(tmp_path_factory, data_dir):
    """The tiny db in pages of 3 sequences: 3 pages."""
    return build_staged(tmp_path_factory.mktemp("torch_pipeline_paged"),
                        data_dir, chunk_size=3)


def _check_against_native_chain(chunks, p, queries, stream, finished,
                                max_ext):
    """Every (query, page) group, query-major, equal to the native chain
    on its page; returns the pages whose groups held hits."""
    assert len(finished) == len(stream.groups)
    assert [(qid, cid) for qid, cid, _lo, _hi in stream.groups] == \
        [(qid, cid) for qid in range(len(queries))
         for cid in range(len(chunks))]
    checked, hit_pages = 0, set()
    for (qid, cid, _lo, _hi), out in zip(stream.groups, finished):
        q_enc, q_sa, q_acc, q_cond = queries[qid]
        full = native.search_chunk(q_enc, q_sa, q_acc, q_cond, chunks[cid],
                                   p)
        for k in EXACT_KEYS:
            assert np.array_equal(out[k], full[k]), k
        np.testing.assert_allclose(out["energy"], full["energy"], atol=3e-4)
        checked += len(full["q_sp"])
        if len(full["q_sp"]):
            hit_pages.add(cid)
    assert checked > 0
    if max_ext == 8:
        assert (stream.soa["q_len"] != stream.soa["pre_q_len"]).any()
    return hit_pages


@pytest.mark.parametrize("max_ext", [32, 8])
def test_search_all_matches_native_chain(staged, max_ext):
    """finish_search on the staged oracle's stream (seed_stage ->
    ungapped_stage -> threshold_stage). max_ext=8 sends many hits through
    the exact-host overflow fallback; the results must still equal the
    native chain."""
    chunks, p, queries, qpack, dbpack, _pres, _posts = staged
    stream = tpl.seed_stage(p, chunks, queries)
    tpl._hit_bases(stream, qpack, dbpack)
    tpl.ungapped_stage(stream, qpack, dbpack, p, device=CPU)
    stream = tpl.threshold_stage(stream, p)
    stream, finished = tpl.finish_search(
        stream, p, chunks, queries, qpack, dbpack, devices=CPU,
        dtype="float64", max_ext=max_ext)
    _check_against_native_chain(chunks, p, queries, stream, finished,
                                max_ext)


@pytest.mark.parametrize("max_ext,db", [
    pytest.param(32, "staged", id="32"), pytest.param(8, "staged", id="8"),
    pytest.param(32, "paged", id="32-3pages"),
    pytest.param(8, "paged", id="8-3pages")])
def test_search_all_fused_matches_native_chain(request, max_ext, db):
    """search_all, whose front is the fused stage; the same limits as the
    staged oracle. On the 3-page db every (query, page) group goes through
    DbPack's per-page bases and the pools' per-page groups, and the
    finished hits lie on a page after the first."""
    chunks, p, queries, qpack, dbpack, _pres, _posts = \
        request.getfixturevalue(db)
    assert len(chunks) == (3 if db == "paged" else 1)
    prof.reset()
    stream, finished = tpl.search_all(p, chunks, queries, qpack, dbpack,
                                      devices=CPU, dtype="float64",
                                      max_ext=max_ext)
    hit_pages = _check_against_native_chain(chunks, p, queries, stream,
                                            finished, max_ext)
    if db == "paged":
        assert max(hit_pages) > 0
    stages = prof.snapshot()
    assert {"ris.seed", "ris.fused", "ris.fused.expand", "ris.fused.ungapped",
            "ris.mid", "ris.gapped", "ris.finish"} <= set(stages)


def test_threshold_compares_float32_energies_in_float64(staged):
    """-4.1 rounds up to float32 (-4.0999999): a float32 energy equal to
    that is above the threshold and must go, as the native engine's double
    comparison drops it; the next float32 below stays. Both the staged
    threshold and the fused one agree."""
    p = staged[1]
    p = dataclasses.replace(p, interaction_energy_threshold=-4.1)
    e32 = np.float32(-4.1)
    assert float(e32) > -4.1
    energy = np.array([e32, np.nextafter(e32, np.float32(-np.inf))],
                      np.float32)
    stream = tpl.HitStream({"q_sp": np.arange(2), "energy": energy},
                           [(0, 0, 0, 2)])
    kept = tpl.threshold_stage(stream, p)
    assert kept.groups == [(0, 0, 0, 1)]
    assert kept.soa["energy"].tolist() == energy[1:].tolist()
    res = {k: torch.zeros(2, dtype=torch.int64)
           for k in ungapped_op.INT_KEYS}
    res.update({k: torch.as_tensor(energy) for k in ungapped_op.FLOAT_KEYS})
    hits = {"dbseq_id": torch.zeros(2, dtype=torch.int64),
            "pid": torch.arange(2)}
    assert fused._thresh_core(p, res, hits)["pid"].tolist() == [1]
