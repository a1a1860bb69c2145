"""The port's fused path (host seed DFS -> device expansion -> ungapped
extension -> threshold, search/seed.py + search/fused.py) on the tiny
goldens, on the CPU, where the ungapped kernel's wrapper runs its plain
version. The set-up is tests/test_torch_ungapped.py:build_staged's; it
mirrors the fused tests of tests/test_search_kernels.py (:61-76, :177-201,
:224-238).
"""

import numpy as np
import pytest
import torch

# the port runs many small tensor ops here: one intra-op thread per test
# worker avoids oversubscribing the host under pytest-xdist
torch.set_num_threads(1)

from priblast_tpu.search import fused as jfused
from priblast_tpu.search import pipeline as jpl
from priblast_tpu_torch.search import fused, seed
from priblast_tpu_torch.search import pipeline as tpl
from test_torch_ungapped import INT_KEYS, build_staged, stream_of

CPU = torch.device("cpu")
FLOAT_KEYS = ("acc_e", "hyb_e", "energy")


@pytest.fixture(scope="module")
def staged(tmp_path_factory, data_dir):
    chunks, p, queries, qpack, dbpack, pres, posts = build_staged(
        tmp_path_factory.mktemp("torch_fused"), data_dir)
    cands = seed.seed_candidates(p, chunks, queries)
    return chunks, p, queries, qpack, dbpack, pres, posts, cands


def test_expansion_matches_native_stage1(staged):
    """_expand_core over the whole wave == native stage 1 (the seed
    expansion of ops/native/search.cc): groups, positions, ids and the
    flat-buffer bases exact; acc_e, hyb_e and their sum bit for bit (both
    sum the window in float64 in the same order)."""
    chunks, p, _queries, qpack, dbpack, pres, _posts, cands = staged
    wb = fused._WaveBuffers(cands, qpack, dbpack, CPU)
    hits = fused._expand_core(p.min_accessible_length, p.max_seed_length, 0,
                              wb.tot, wb, qpack, dbpack)
    hits = {k: v.numpy() for k, v in hits.items()}
    ref = stream_of(pres, qpack, dbpack)
    assert len(ref) > 0 and len(hits["pid"]) == len(ref)
    assert [(q, c) for q, c, _, _ in wb.gbounds] == \
        [(q, c) for q, c, _, _ in ref.groups]
    for (_q, _c, plo, phi), (_q2, _c2, lo, hi) in zip(wb.gbounds,
                                                       ref.groups):
        assert np.searchsorted(hits["pid"], plo) == lo
        assert np.searchsorted(hits["pid"], phi) == hi
    for k in ("q_sp", "db_sp", "dbseq_id", "dbseq_start", "qb", "qab", "dbb",
              "aoff", "coff"):
        assert np.array_equal(hits[k], ref.soa[k]), k
    assert np.array_equal(hits["length"], ref.soa["q_len"])
    assert np.array_equal(hits["length"], ref.soa["db_len"])
    for k in ("acc_e", "hyb_e"):
        assert hits[k].dtype == np.float64
        assert np.array_equal(hits[k].view(np.uint64),
                              ref.soa[k].view(np.uint64)), k
    energy = hits["acc_e"] + hits["hyb_e"]
    assert np.array_equal(energy.view(np.uint64),
                          ref.soa["energy"].view(np.uint64))


def test_fused_stage_matches_native_stage2(staged):
    """fused_stage == native stage 2 filtered by the interaction threshold:
    groups and integer fields exact; energies to the float32 step noise
    the staged path is held to (atol 2e-4, rtol 1e-5: the extension keeps
    the reference's float32 steps, the native engine sums them in
    float64). The fused stage has no dtype: its expansion is float64 and
    its extension float32 whatever the device engine's dtype, so the JAX
    test's float32/float64 cases are one here."""
    _chunks, p, _queries, qpack, dbpack, _pres, posts, cands = staged
    stream = fused.fused_stage(p, cands, qpack, dbpack, devices=CPU)
    assert len(stream) > 0
    thr = p.interaction_energy_threshold
    assert len(stream.groups) == len(posts)
    for (_qid, _cid, lo, hi), post in zip(stream.groups, posts):
        keep = np.asarray(post["energy"]) <= thr
        assert hi - lo == int(keep.sum())
        for k in INT_KEYS:
            assert np.array_equal(stream.soa[k][lo:hi],
                                  np.asarray(post[k])[keep]), k
        for k in FLOAT_KEYS:
            np.testing.assert_allclose(stream.soa[k][lo:hi],
                                       np.asarray(post[k])[keep],
                                       atol=2e-4, rtol=1e-5)


def test_fused_stage_matches_jax_fused_stage(staged):
    """The port's fused_stage against the JAX package's, on the same
    candidates (JAX in float64, whose window sums from hi/lo float32
    prefix sums, pipeline._prefix_hilo, round to the same float32 acc_e
    here): groups and integer fields exact; energies to 1e-5 absolute, ten
    float32 ulps at |e| ~ 10 kcal/mol, because XLA's CPU backend computes
    each loop energy's x / 100 as x * 0.01 fused with the next add, so a
    paired step can differ by an ulp (measured: 2e-6 at most)."""
    chunks, p, queries, qpack, dbpack, _pres, _posts, cands = staged
    jq = jpl.QueryPack([q[0].astype(np.int32) for q in queries],
                       [q[2] for q in queries], [q[3] for q in queries],
                       [q[1] for q in queries])
    jd = jpl.DbPack(chunks)
    ref = jfused.fused_stage(p, cands, jq, jd, dtype="float64")
    got = fused.fused_stage(p, cands, qpack, dbpack, devices=CPU)
    assert len(got) > 0 and got.groups == ref.groups
    for k in INT_KEYS:
        assert np.array_equal(got.soa[k], np.asarray(ref.soa[k])), k
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(got.soa[k], np.asarray(ref.soa[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_fused_stream_equals_staged_stream(staged):
    """The fused stream and the port's staged one (native stage 1 ->
    ungapped_stage -> threshold_stage) are the same stream: groups, and
    every field identical in value and dtype."""
    _chunks, p, _queries, qpack, dbpack, pres, _posts, cands = staged
    got = fused.fused_stage(p, cands, qpack, dbpack, devices=CPU)
    ref = stream_of(pres, qpack, dbpack)
    tpl.ungapped_stage(ref, qpack, dbpack, p, device=CPU)
    ref = tpl.threshold_stage(ref, p)
    assert len(got) > 0 and got.groups == ref.groups
    assert set(got.soa) == set(tpl.STREAM_KEYS)
    for k in tpl.STREAM_KEYS:
        assert got.soa[k].dtype == ref.soa[k].dtype, k
        assert np.array_equal(got.soa[k], ref.soa[k]), k


def test_small_pair_blocks_give_the_same_stream(staged):
    """Pair blocks of 4 (candidates here hold up to 10 pairs, so some span
    three or four blocks) give the stream of one block for the wave: the
    block size bounds memory only."""
    _chunks, p, _queries, qpack, dbpack, _pres, _posts, cands = staged
    wb = fused._WaveBuffers(cands, qpack, dbpack, CPU)
    assert int(torch.diff(wb.cum).max()) > 2 * 4
    one = fused.fused_stage(p, cands, qpack, dbpack, devices=CPU,
                            block=wb.tot)
    small = fused.fused_stage(p, cands, qpack, dbpack, devices=CPU,
                              block=4)
    assert len(one) > 0 and small.groups == one.groups
    for k in tpl.STREAM_KEYS:
        assert np.array_equal(small.soa[k], one.soa[k]), k


def test_fused_stage_without_pairs_or_survivors(staged):
    """A wave with no candidates, and groups whose candidates all fail the
    filter, keep their (empty) groups in order."""
    _chunks, p, _queries, qpack, dbpack, _pres, _posts, cands = staged
    none = fused.fused_stage(p, [], qpack, dbpack, devices=CPU)
    assert len(none) == 0 and none.groups == []
    weak = [(g, {**c, "hyb_e": np.full_like(c["hyb_e"], 1e3)})
            for g, c in cands[:2]] + cands[2:3]
    stream = fused.fused_stage(p, weak, qpack, dbpack, devices=CPU)
    assert [g[2:] for g in stream.groups[:2]] == [(0, 0), (0, 0)]
    assert stream.groups[2][:2] == cands[2][0]
    alone = fused.fused_stage(p, cands[2:3], qpack, dbpack, devices=CPU)
    assert len(alone) > 0 and len(stream) == len(alone)
    for k in tpl.STREAM_KEYS:
        assert stream.soa[k].dtype == alone.soa[k].dtype
        assert np.array_equal(stream.soa[k], alone.soa[k]), k
