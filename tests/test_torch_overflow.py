"""The gapped stage's host overflow fallback (search/pipeline.py:
OverflowFallback, then assemble_bps) against the JAX package's
(priblast_tpu/search/pipeline.py:_overflow_fallback, then its gapped_stage's
assembly: per hit, seed pairs, then left, then right), on the tiny goldens
on the CPU. Both get the same post-mid stream, the same device results at
max_ext = 8 (every one of the 218 hits overflows) or 16 (20 of them do)
and the same overflow flags: the kernel's own, none, every hit, and the
first or the last hit of each group. Stream fields and base pairs must be
exact, at one thread and at four; and the port's results byte for byte at
one and four threads, and with the flags submitted at once or in batches
that cut the groups."""

import numpy as np
import pytest
import torch

# the port runs many small tensor ops here: one intra-op thread per test
# worker avoids oversubscribing the host under pytest-xdist
torch.set_num_threads(1)

from priblast_tpu.search import pipeline as jpl
from priblast_tpu_torch.search import pipeline as tpl
from priblast_tpu_torch.search.gapped import gapped_extend_flat_batch
from test_torch_ungapped import build_staged

CPU = torch.device("cpu")
CASES = ("kernel", "none", "every", "first", "last")


@pytest.fixture(scope="module", params=[8, 16])
def gapped(request, tmp_path_factory, data_dir):
    """The stream after the device part of gapped_stage at max_ext =
    request.param (pre-extension state in pre_*), its seed pairs, the
    device's base pairs and its overflow flags."""
    chunks, p, queries, qpack, dbpack, _pres, _posts = build_staged(
        tmp_path_factory.mktemp("torch_overflow"), data_dir)
    stream = tpl.seed_stage(p, chunks, queries)
    tpl._hit_bases(stream, qpack, dbpack)
    tpl.ungapped_stage(stream, qpack, dbpack, p, device=CPU)
    stream = tpl.threshold_stage(stream, p)
    stream, seed_bps = tpl.mid_stage(stream, queries, chunks, p)
    tpl._hit_bases(stream, qpack, dbpack)
    for k in tpl.STREAM_KEYS:
        stream.soa[f"pre_{k}"] = stream.soa[k].copy()
    sub = {k: stream.soa[k] for k in (*tpl.STREAM_KEYS, *tpl._BASE_KEYS)}
    g, bp, overflow = gapped_extend_flat_batch(
        sub, qpack.bufs, dbpack.bufs, d=p.min_accessible_length,
        dropout=p.drop_out_length_w_gap, min_helix=p.min_helix_length,
        max_ext=request.param, device=CPU)
    for k in tpl.STREAM_KEYS:
        stream.soa[k] = g[k]
    assert overflow.sum() > 0
    assert len(stream.groups) > 1
    return chunks, p, queries, stream, seed_bps, bp, overflow


def _flags(stream, overflow, case):
    if case == "kernel":
        return overflow
    flags = np.full(len(stream), case == "every")
    for _qid, _cid, lo, hi in stream.groups:
        if hi > lo and case == "first":
            flags[lo] = True
        if hi > lo and case == "last":
            flags[hi - 1] = True
    return flags


def _copy(mod, stream):
    return mod.HitStream({k: v.copy() for k, v in stream.soa.items()},
                         list(stream.groups))


def _port(gapped, flags, threads, batch=None):
    """The port's fallback, the flags submitted in batches of `batch`
    hits (all at once for None), as gapped_stage submits its hit
    batches."""
    chunks, p, queries, stream, seed_bps, bp, _ov = gapped
    st = _copy(tpl, stream)
    batch = batch or len(flags)
    with tpl.OverflowFallback(st, chunks, queries, p, threads) as fb:
        for o in range(0, len(flags), batch):
            fb.submit(flags[o: o + batch], o)
        segments = fb.patch([(np.diff(seed_bps["bp_off"]), seed_bps["bp_q"],
                              seed_bps["bp_db"]),
                             (bp["n0"], bp["q0"], bp["db0"]),
                             (bp["n1"], bp["q1"], bp["db1"])])
    return st, tpl.assemble_bps(segments)


def _jax(gapped, flags):
    chunks, p, queries, stream, seed_bps, bp, _ov = gapped
    st = _copy(jpl, stream)
    jbp = {k: v.copy() for k, v in bp.items()}
    if flags.any():
        jpl._overflow_fallback(st, jbp, flags, chunks, queries, p)
    q, db, off = [], [], [0]
    o0 = np.concatenate([[0], np.cumsum(jbp["n0"])])
    o1 = np.concatenate([[0], np.cumsum(jbp["n1"])])
    so = seed_bps["bp_off"]
    for i in range(len(stream)):
        for src, lo, hi in ((seed_bps, so[i], so[i + 1]),
                            ({"bp_q": jbp["q0"], "bp_db": jbp["db0"]},
                             o0[i], o0[i + 1]),
                            ({"bp_q": jbp["q1"], "bp_db": jbp["db1"]},
                             o1[i], o1[i + 1])):
            q.extend(src["bp_q"][lo:hi])
            db.extend(src["bp_db"][lo:hi])
        off.append(len(q))
    return st, dict(bp_off=np.asarray(off, np.int64),
                    bp_q=np.asarray(q, np.int32),
                    bp_db=np.asarray(db, np.int32))


def _same(a, b):
    (sa, ba), (sb, bb) = a, b
    assert sa.groups == sb.groups
    for k in tpl.STREAM_KEYS:
        assert sa.soa[k].dtype == sb.soa[k].dtype, k
        assert np.array_equal(sa.soa[k], sb.soa[k]), k
    for k in ("bp_off", "bp_q", "bp_db"):
        assert ba[k].dtype == bb[k].dtype, k
        assert np.array_equal(ba[k], bb[k]), k


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("case", CASES)
def test_fallback_matches_jax(gapped, case, threads):
    flags = _flags(gapped[3], gapped[6], case)
    port = _port(gapped, flags, threads)
    _same(port, _jax(gapped, flags))
    stream = gapped[3]
    changed = np.zeros(len(stream), bool)
    for k in tpl.STREAM_KEYS:
        changed |= port[0].soa[k] != stream.soa[k]
    # only flagged hits change, and the kernel's own flagged hits do
    assert not (changed & ~flags).any()
    if case == "kernel":
        assert changed.any()


@pytest.mark.parametrize("batch", [None, 37])
def test_fallback_threads_give_the_same_bytes(gapped, batch):
    """threads=1 and threads=4, whole or in batches of 37 hits (which cut
    every group of the tiny set): the same bytes."""
    for case in ("kernel", "every"):
        flags = _flags(gapped[3], gapped[6], case)
        (s1, b1) = _port(gapped, flags, 1)
        (s4, b4) = _port(gapped, flags, 4, batch)
        for k in tpl.STREAM_KEYS:
            assert s1.soa[k].tobytes() == s4.soa[k].tobytes(), k
        for k in b1:
            assert b1[k].tobytes() == b4[k].tobytes(), k
