"""The port's gapped extension (planes + the sweep's plain version +
traceback, ops/gapped_sweep.py) on the mid-stage hits of the tiny goldens,
on the CPU, against:

- the JAX package's XLA form, float64 and float32: extents, dbseq_start,
  overflow and base pairs exact; energies to 1e-12 (float64) and to 2
  float32 ulps of their size in float32 (the largest difference seen on
  this batch is 2 ulps). The port runs the XLA body's operations in the
  same order, but XLA's CPU backend turns x / 100 into x * 0.01 fused with
  the following add; the port divides, as the reference does.
- the JAX package's Pallas sweep in interpret mode (float32), the same way;
- the native host engine (float64, max_ext=64): everything exact, energies
  to 1e-9, as tests/test_search_kernels.py:92-130 holds the JAX form;
- a ragged batch (37 hits, max_ext=64), and a batch of periodic sequences
  built to contain equal-energy combos, where the stems-order tie rule
  decides the traceback.
"""

import jax
import numpy as np
import pytest
import torch

# the port runs many small tensor ops here: one intra-op thread per test
# worker avoids oversubscribing the host under pytest-xdist
torch.set_num_threads(1)

from priblast_tpu.search import gapped as jgapped
from priblast_tpu.search import pipeline as jpl
from priblast_tpu_torch.models import db as tdb
from priblast_tpu_torch.ops import gapped_sweep as sweep_op
from priblast_tpu_torch.ops import native
from priblast_tpu_torch.search import gapped as tgapped
from priblast_tpu_torch.search import pipeline as tpl
from priblast_tpu_torch.utils import alphabet, store
from priblast_tpu_torch.utils import profiling as prof
from priblast_tpu_torch.utils.params import DbParams, RisParams
from test_torch_ungapped import build_staged, stream_of

CPU = torch.device("cpu")
EXT_KEYS = ("q_sp", "db_sp", "q_len", "db_len", "dbseq_start")
HIT_COLS = (*tpl.STREAM_KEYS, "qb", "qab", "dbb", "aoff", "coff")
KW = dict(d=5, dropout=16, min_helix=3)


def _mids(queries, chunk, p, posts):
    return [native.chain_mid(queries[qid][0], chunk, p, post)
            for qid, post in enumerate(posts)]


@pytest.fixture(scope="module")
def mid_batch(tmp_path_factory, data_dir):
    chunks, p, queries, qpack, dbpack, _pres, posts = build_staged(
        tmp_path_factory.mktemp("torch_gapped"), data_dir)
    mids = _mids(queries, chunks[0], p, posts)
    stream = stream_of(mids, qpack, dbpack)
    sub = {k: stream.soa[k] for k in HIT_COLS}
    jq = jpl.QueryPack([q[0].astype(np.int32) for q in queries],
                       [q[2] for q in queries], [q[3] for q in queries])
    jd = jpl.DbPack(chunks)
    jsub = {k: v.astype(np.int32) if v.dtype == np.int64 else v
            for k, v in sub.items()}
    return dict(chunks=chunks, p=p, queries=queries, qpack=qpack,
                dbpack=dbpack, mids=mids, stream=stream, sub=sub, jq=jq,
                jd=jd, jsub=jsub)


def _port(mb, sub=None, **kw):
    return tgapped.gapped_extend_flat_batch(
        mb["sub"] if sub is None else sub, mb["qpack"].bufs,
        mb["dbpack"].bufs, device=CPU, **KW, **kw)


def _assert_same(port, ref, f32: bool):
    (g1, b1, o1), (g2, b2, o2) = port, ref
    assert o1.any() == o2.any() and np.array_equal(o1, o2)
    for k in EXT_KEYS:
        assert np.array_equal(g1[k], g2[k]), k
    for k in b1:
        assert np.array_equal(b1[k], b2[k]), k
    for k in ("energy", "acc_e", "hyb_e"):
        if f32:
            ref = np.asarray(g2[k], np.float32)
            diff = np.abs(np.asarray(g1[k], np.float64) - ref)
            assert (diff <= 2 * np.spacing(np.abs(ref))).all(), k
        else:
            assert np.abs(g1[k] - g2[k]).max() <= 1e-12, k


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_gapped_matches_jax_xla_form(mid_batch, dtype):
    mb = mid_batch
    assert len(mb["sub"]["q_sp"]) > 100
    port = _port(mb, max_ext=32, dtype=dtype)
    ref = jgapped.gapped_extend_flat_batch(
        mb["jsub"], mb["jq"].bufs, mb["jd"].bufs, max_ext=32, dtype=dtype,
        **KW)
    assert port[2].any()   # the cap is reached: overflow is exercised
    _assert_same(port, ref, dtype == "float32")


def test_gapped_matches_jax_pallas_interpret(mid_batch, monkeypatch):
    """The Pallas sweep's mode is read while tracing (gapped.py:94), so the
    jit caches are cleared around the switch. The JAX wrapper pads the
    batch to a power of two, which is a multiple of its block."""
    mb = mid_batch
    monkeypatch.setenv("PRIBLAST_GAPPED_PALLAS", "interpret")
    jax.clear_caches()
    try:
        ref = jgapped.gapped_extend_flat_batch(
            mb["jsub"], mb["jq"].bufs, mb["jd"].bufs, max_ext=32,
            dtype="float32", **KW)
    finally:
        monkeypatch.delenv("PRIBLAST_GAPPED_PALLAS")
        jax.clear_caches()
    _assert_same(_port(mb, max_ext=32, dtype="float32"), ref, True)


def _assert_matches_native(mb, gx, bps, ovf, mids, stream):
    assert not ovf.any()
    off0 = np.concatenate([[0], np.cumsum(bps["n0"])])
    off1 = np.concatenate([[0], np.cumsum(bps["n1"])])
    for (qid, _cid, lo, hi), mid in zip(stream.groups, mids):
        q = mb["queries"][qid]
        ref = native.gapped_extend(q[0], q[2], q[3], mb["chunks"][0],
                                   mb["p"], mid)
        for k in EXT_KEYS:
            assert np.array_equal(gx[k][lo:hi], ref[k]), k
        np.testing.assert_allclose(gx["energy"][lo:hi], ref["energy"],
                                   atol=1e-9)
        np.testing.assert_allclose(gx["acc_e"][lo:hi], ref["acc_e"],
                                   atol=1e-9)
        for gi, i in enumerate(range(lo, hi)):
            got = (list(zip(bps["q0"][off0[i]:off0[i + 1]].tolist(),
                            bps["db0"][off0[i]:off0[i + 1]].tolist()))
                   + list(zip(bps["q1"][off1[i]:off1[i + 1]].tolist(),
                              bps["db1"][off1[i]:off1[i + 1]].tolist())))
            blo, bhi = ref["bp_off"][gi], ref["bp_off"][gi + 1]
            assert got == list(zip(ref["bp_q"][blo:bhi].tolist(),
                                   ref["bp_db"][blo:bhi].tolist()))


def test_gapped_matches_native_oracle(mid_batch):
    mb = mid_batch
    gx, bps, ovf = _port(mb, max_ext=64, dtype="float64")
    _assert_matches_native(mb, gx, bps, ovf, mb["mids"], mb["stream"])


def test_gapped_ragged_batch(mid_batch):
    """37 hits at max_ext=64: the same results as in the full batch (no
    lane is dropped or mixed up for a batch that fills no block)."""
    mb = mid_batch
    full = _port(mb, max_ext=64, dtype="float32")
    sub = {k: v[:37] for k, v in mb["sub"].items()}
    part = _port(mb, sub=sub, max_ext=64, dtype="float32")
    for k in EXT_KEYS + ("energy", "acc_e"):
        assert np.array_equal(part[0][k], full[0][k][:37]), k
    assert np.array_equal(part[2], full[2][:37])
    for side in ("0", "1"):
        n = full[1]["n" + side][:37]
        assert np.array_equal(part[1]["n" + side], n)
        for c in ("q", "db"):
            assert np.array_equal(part[1][c + side],
                                  full[1][c + side][: n.sum()])


@pytest.mark.parametrize("form", ["worklist", "lanes", None])
def test_gapped_counts_the_hits_of_the_work_list(mid_batch, monkeypatch,
                                                 form):
    """`ris.gapped.worklist_hits` adds the hits of a batch whose kernel
    runs the work list (the form is the wrapper's `kernel_form`, here
    stood in for as on the card), `ris.gapped.hits` every batch's; the
    results do not depend on it (the plain version runs on the CPU)."""
    mb = mid_batch
    n = len(mb["sub"]["q_sp"])
    ref = _port(mb, max_ext=32, dtype="float64")
    seen = []

    def stand_in(max_ext, device):
        seen.append((max_ext, torch.device(device).type))
        return form

    monkeypatch.setattr(sweep_op, "kernel_form", stand_in)
    before = prof.counters()
    got = _port(mb, max_ext=32, dtype="float64")
    after = prof.counters()
    assert seen == [(32, "cpu")]
    assert after["ris.gapped.hits"] - before.get("ris.gapped.hits", 0) == n
    assert (after.get("ris.gapped.worklist_hits", 0)
            - before.get("ris.gapped.worklist_hits", 0)
            == (n if form == "worklist" else 0))
    _assert_same(got, ref, False)


def test_gapped_tie_rule_on_periodic_sequences(tmp_path, monkeypatch):
    """Repeated self-complementary blocks give many predecessor combos of
    equal energy. With the stems-order first-minimum rule the port equals
    the native engine exactly; scanning the combos in reverse order (last
    minimum wins) changes the predecessor rows, so the batch does hold
    ties that the rule decides."""
    rng = np.random.default_rng(5)

    def flank(n):
        return "".join(rng.choice(list("ACGU"), n))

    unit = "GGCGCCAUAU"
    db_fa = tmp_path / "db.fa"
    q_fa = tmp_path / "q.fa"
    db_fa.write_text("".join(f">t{i}\n{flank(40)}{unit * (6 + i)}"
                             f"{flank(40)}\n" for i in range(3)))
    q_fa.write_text("".join(f">q{i}\n{flank(30)}{unit * (5 + i)}"
                            f"{flank(30)}\n" for i in range(2)))
    db_name = str(tmp_path / "pdb")
    tdb.run(DbParams(input=str(db_fa), db_name=db_name, engine="exact"))
    chunks = store.load_chunks(db_name, 8)
    p = RisParams(input="x", output="y", db_name=db_name, engine="exact")
    p.load_db_params()
    from priblast_tpu_torch.utils import fasta

    _n, seqs = fasta.read_fasta(q_fa)
    queries, posts = [], []
    for seq in seqs:
        q_acc, q_cond = native.raccess(alphabet.access_codes(seq), 70, 5)
        q_enc = alphabet.encode_query(seq, p.repeat_flag)
        q_sa = native.sa_build(q_enc)
        queries.append((q_enc, q_sa, q_acc, q_cond))
        posts.append(native.search_chunk(q_enc, q_sa, q_acc, q_cond,
                                         chunks[0], p, stage=2))
    mids = _mids(queries, chunks[0], p, posts)
    qpack = tpl.QueryPack([q[0] for q in queries], [q[2] for q in queries],
                          [q[3] for q in queries], [q[1] for q in queries],
                          devices=CPU)
    dbpack = tpl.DbPack(chunks, devices=CPU)
    stream = stream_of(mids, qpack, dbpack)
    assert len(stream) >= 8
    mb = dict(queries=queries, chunks=chunks, p=p, qpack=qpack,
              dbpack=dbpack, sub={k: stream.soa[k] for k in HIT_COLS})
    gx, bps, ovf = _port(mb, max_ext=64, dtype="float64")
    _assert_matches_native(mb, gx, bps, ovf, mids, stream)

    preds = []
    orig = sweep_op.sweep_plain

    def keep_pred(*a, **k):
        out = orig(*a, **k)
        preds.append(out[0])
        return out

    monkeypatch.setattr(sweep_op, "sweep_plain", keep_pred)
    _port(mb, max_ext=64, dtype="float64")
    first = list(preds)
    preds.clear()
    stems_order = sweep_op.combos
    monkeypatch.setattr(sweep_op, "combos",
                        lambda dropout: stems_order(dropout)[::-1])
    _port(mb, max_ext=64, dtype="float64")
    assert any(not torch.equal(a, b) for a, b in zip(first, preds))
