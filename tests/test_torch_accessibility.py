"""The port's batched accessibility engine against the JAX engine and the
native exact engine, on the batch of tests/test_tpu_engine.py, on the CPU.

Tolerances:
- float64: the window energies -kT log p / 1000, formed in float64 from
  the window probabilities of both engines, agree to 1e-9 kcal/mol (both
  evaluate the same float64 recurrences over the same float32-rounded
  tables; they differ only in summation order).
- The float32 outputs of both engines differ by at most a few float32
  ulps in float64 mode: the final -kT log p is taken in float32, and
  XLA's float32 log and PyTorch's differ in the last bit.
- float32 engine: 2e-3 kcal/mol against JAX and against the native
  engine, the repo's own float32 bound (tests/test_tpu_engine.py:24).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the port runs many small tensor ops here: one intra-op thread per test
# worker avoids oversubscribing the host under pytest-xdist
torch.set_num_threads(1)

from priblast_tpu.accessibility import batched as jb
from priblast_tpu_torch.accessibility import batched as tb
from priblast_tpu_torch.ops import native
from priblast_tpu_torch.utils import alphabet, fasta

W_SPAN, D = 70, 5


@pytest.fixture(scope="module")
def tiny_batch(data_dir):
    names, seqs = fasta.read_fasta(data_dir / "tiny_db.fa")
    seqs = seqs[:4]
    n_max = max(len(s) for s in seqs)
    codes = np.zeros((len(seqs), n_max), np.uint8)
    lens = np.array([len(s) for s in seqs], np.int32)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = alphabet.access_codes(s)
    exact = [native.raccess(alphabet.access_codes(s), W_SPAN, D)
             for s in seqs]
    return seqs, codes, lens, exact


def _jax_window_probs(s_np, lens, n_max, dtype_name, d=D):
    """p_w and p_w1 of the JAX engine at window size d (the
    _run_batch_impl passes, before its float32 log)."""
    dtype = jnp.dtype(dtype_name).type
    band = W_SPAN + 2
    B = s_np.shape[0]
    t = jb.make_tables(W_SPAN, dtype=jnp.dtype(dtype_name))

    def probs(s, lengths):
        g = jb.make_grids(t, s, lengths, n_max, band, dtype)
        ins = jb.inside_pass(t, g, n_max, band, B, dtype)
        A = ins[6]
        logZ = jnp.take_along_axis(A, lengths[None, :], axis=0)[0]
        Bf = jb.b_outer_scan(ins[0], g.ext_dot, n_max, band, B, dtype,
                             lengths)
        og = jb.make_outside_grids(t, s, lengths, n_max, band, dtype, g,
                                   ins[5], A, Bf, logZ)
        outs = jb.outside_pass(t, og, ins[4], n_max, band, B, dtype)
        pg = jb.make_prob_grids(t, s, n_max, band, dtype)
        r = jb.probability_pass(t, g, pg, ins, outs, A, Bf, logZ, d, n_max,
                                band, dtype)
        return r[0] + r[2] + r[4] + r[6], r[1] + r[3] + r[5] + r[7]

    pw, pw1 = jax.jit(probs)(jnp.asarray(s_np.astype(np.int32)),
                             jnp.asarray(lens))
    return np.asarray(pw), np.asarray(pw1)


def _padded(codes):
    n_max = codes.shape[1]
    s_np = np.zeros((codes.shape[0], n_max + jb.ML + 4), np.int64)
    s_np[:, 1: n_max + 1] = codes
    return s_np


def test_float64_window_energies_match_jax(tiny_batch):
    seqs, codes, lens, _exact = tiny_batch
    n_max = codes.shape[1]
    s_np = np.zeros((len(seqs), n_max + jb.ML + 4), np.int64)
    s_np[:, 1: n_max + 1] = codes
    pj, _ = _jax_window_probs(s_np, lens, n_max, "float64")
    pt, _ = tb.window_probabilities(W_SPAN, D, n_max, torch.float64,
                                    torch.as_tensor(s_np),
                                    torch.as_tensor(lens.astype(np.int64)))
    pt = pt.numpy()
    kT = tb._linmodel(W_SPAN).sp.kT
    for i, n in enumerate(lens):
        win = slice(1, n - D + 2)   # window starts x = 1 .. n - D + 1
        ej = -kT * np.log(pj[win, i]) / 1000
        et = -kT * np.log(pt[win, i]) / 1000
        assert np.abs(ej - et).max() <= 1e-9


@pytest.mark.parametrize("d", [1, 2])
def test_float64_window_energies_match_jax_at_small_windows(tiny_batch, d):
    """Windows of d and d + 1 <= 3 nt, where probability_pass spreads the
    small-loop specials (1,0) .. (2,2) (batched.py:870-877; the JAX
    package's :1290-1301): both window sizes' energies to 1e-9 kcal/mol
    in float64."""
    seqs, codes, lens, _exact = tiny_batch
    n_max = codes.shape[1]
    s_np = _padded(codes)
    pj = _jax_window_probs(s_np, lens, n_max, "float64", d)
    pt = tb.window_probabilities(W_SPAN, d, n_max, torch.float64,
                                 torch.as_tensor(s_np),
                                 torch.as_tensor(lens.astype(np.int64)))
    kT = tb._linmodel(W_SPAN).sp.kT
    for k, size in enumerate((d, d + 1)):
        for i, n in enumerate(lens):
            win = slice(1, n - size + 2)   # starts x = 1 .. n - size + 1
            ej = -kT * np.log(pj[k][win, i]) / 1000
            et = -kT * np.log(pt[k].numpy()[win, i]) / 1000
            assert np.isfinite(et).all()
            assert np.abs(ej - et).max() <= 1e-9


def test_batched_raccess_float64_energies_match_jax(tiny_batch, monkeypatch):
    """BatchedRaccess.run in float64, through its one call per batch
    (batch_energies: the probability pass writes the energies), against
    the JAX engine's window probabilities (the _run_batch_impl passes)
    through the same float32 epilogue (accessibility_from_probabilities):
    acc and cond within 1e-9 kcal/mol, as the float64 energies above (the
    two engines' p_w and p_w1 round to the same float32 values)."""
    _seqs, codes, lens, _exact = tiny_batch
    n_max = codes.shape[1]
    calls = []
    energies0 = tb.batch_energies

    def spy(*a, **k):
        calls.append(a[4].shape[0])
        return energies0(*a, **k)

    monkeypatch.setattr(tb, "batch_energies", spy)
    got = tb.BatchedRaccess(W_SPAN, D, "float64", devices="cpu").run(codes,
                                                                      lens)
    assert calls == [len(lens)]
    pj = _jax_window_probs(_padded(codes), lens, n_max, "float64")
    ref = tb.accessibility_from_probabilities(
        *(torch.as_tensor(np.array(x)) for x in pj),
        torch.as_tensor(lens.astype(np.int64)), D, n_max,
        tb._linmodel(W_SPAN).sp.kT)
    for a, b in zip(got, ref):
        assert a.dtype == np.float32 and float(np.abs(a).max()) > 0
        assert np.abs(a.astype(np.float64) - b.numpy()).max() <= 1e-9


def test_batched_raccess_one_row_equals_its_row_in_two(tiny_batch):
    """A batch of one row (run as two copies of it, then sliced) gives
    that row the bits it gets in a batch of two, float32."""
    _seqs, codes, lens, _exact = tiny_batch
    engine = tb.BatchedRaccess(W_SPAN, D, "float32", devices="cpu")
    two = engine.run(codes[:2], lens[:2])
    for i in (0, 1):
        one = engine.run(codes[i: i + 1], lens[i: i + 1])
        for a, b in zip(one, two):
            assert a.shape == (1, codes.shape[1])
            assert np.array_equal(a[0].view(np.uint32), b[i].view(np.uint32))


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_outputs_match_exact_at_small_windows(tiny_batch, dtype, d):
    """acc and cond of BatchedRaccess at d = 1 and 2 (the specials'
    branch) against the native exact engine, within the repo's float32
    bound of 2e-3 kcal/mol."""
    seqs, codes, lens, _exact = tiny_batch
    pa, pc = tb.BatchedRaccess(W_SPAN, d, dtype=dtype,
                               devices="cpu").run(codes, lens)
    for i, s in enumerate(seqs):
        ra, rc = native.raccess(alphabet.access_codes(s), W_SPAN, d)
        assert np.abs(pa[i, : len(s) - d + 1] - ra[: len(s) - d + 1]).max() \
            < 2e-3
        assert np.abs(pc[i, d: len(s)] - rc[d: len(s)]).max() < 2e-3


@pytest.mark.parametrize("dtype,tol", [("float64", 5e-6),
                                       ("float32", 2e-3)])
def test_outputs_match_jax_and_exact(tiny_batch, dtype, tol):
    seqs, codes, lens, exact = tiny_batch
    ja, jc = jb.BatchedRaccess(W_SPAN, D, dtype=dtype).run(codes, lens)
    pa, pc = tb.BatchedRaccess(W_SPAN, D, dtype=dtype,
                               devices="cpu").run(codes, lens)
    assert pa.dtype == np.float32 and pa.shape == ja.shape
    assert np.abs(pa - ja).max() <= tol
    assert np.abs(pc - jc).max() <= tol
    for i, s in enumerate(seqs):
        ra, rc = exact[i]
        assert np.abs(pa[i, : len(s)] - ra).max() < 2e-3
        assert np.abs(pc[i, : len(s)] - rc).max() < 2e-3


def test_long_sequence_log_space_branch():
    """A sequence whose |logZ| passes 690, where the reference sums the
    bulge/internal-loop window probabilities in log space
    (src/raccess.cpp:683-771). The sequence of tests/test_scale.py:17
    (seed 9) at 3000 nt has logZ = 763.8 (2700 nt: 679.0, still the linear
    branch). The port applies the linear branch's float32 clamp only where
    the reference takes that branch, so it stays with the native engine to
    the envelope tests/test_scale.py sets (~0.05 kcal/mol worst case, fmath
    noise in the bulk); the JAX engine clamps here too and is off by up to
    2.5 kcal/mol on this sequence, which the test also checks."""
    rng = random.Random(9)
    n = 3000
    s = "".join(rng.choice("ACGU") for _ in range(n))
    codes = alphabet.access_codes(s)
    ra, rc = native.raccess(codes, W_SPAN, D)
    s_pad = np.zeros((1, n + tb.ML + 4), np.int64)
    s_pad[0, 1: n + 1] = codes
    with torch.no_grad():
        t = tb.make_tables(W_SPAN, torch.float64)
        g = tb.make_grids(t, torch.as_tensor(s_pad), torch.tensor([n]), n,
                          W_SPAN + 2, torch.float64)
        A = tb.inside_pass(t, g, n, W_SPAN + 2, 1, torch.float64)[6]
    assert float(A[n, 0]) > 690
    acc, cond = tb.BatchedRaccess(W_SPAN, D, dtype="float64",
                                  devices="cpu").run(codes[None, :],
                                                    np.array([n]))
    da = np.abs(acc[0] - ra)
    dc = np.abs(cond[0] - rc)
    assert da.max() < 0.05 and dc.max() < 0.05, (da.max(), dc.max())
    assert np.quantile(da, 0.999) < 1e-3
    assert np.quantile(dc, 0.999) < 1e-3
    ja, _jc = jb.BatchedRaccess(W_SPAN, D, dtype="float64").run(
        codes[None, :], np.array([n], np.int32))
    assert np.abs(ja[0] - ra).max() > 0.05
