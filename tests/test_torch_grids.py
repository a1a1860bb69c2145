"""The port's plain weight grids against the JAX package's, field by field,
on the CPU: accessibility/batched.py:make_grids and make_outside_grids of
both packages on the same inputs, made with numpy (the first three
tiny_db.fa sequences and the first 40 nt of the fourth, shorter than the
band: a ragged batch). The JAX side runs on XLA:CPU, where it takes its
`_packed_take` gathers (the one-hot bilinear lookups are TPU-only,
priblast_tpu/accessibility/batched.py:_use_bilinear). Both sides' outside
grids take the JAX package's inside pass (multi2, A, B_outer and logZ) as
their inputs.

Tolerances, float64 and float32:
- the bool planes and every gathered plane (table values, their float32
  products and their products with sigma^-k): exact;
- the bulge specials sp10, sp01, spo10 and spo01, b1 · w · sigma^-1:
  in float32 XLA reassociates the product of its two constants, so they
  agree within 1 ulp there (exact in float64, where the last product is
  taken in float64 on both sides);
- the seed exp(A + B - logZ + d lsig): XLA's exp and PyTorch's round
  otherwise, within SEED_ULPS ulps (the sum before the exp is taken in
  the same order and type on both sides).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from priblast_tpu.accessibility import batched as jb
from priblast_tpu_torch.accessibility import batched as tb
from priblast_tpu_torch.utils import alphabet, fasta

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"
W_SPAN, N_SEQ, SHORT = 70, 4, 40
BAND = W_SPAN + 2
SEED_ULPS = 2
BULGE_SPECIALS = ("sp10", "sp01", "spo10", "spo01")
_INT_VIEW = {np.dtype(np.float32): np.int32, np.dtype(np.float64): np.int64}


@pytest.fixture(scope="module")
def inputs():
    _names, seqs = fasta.read_fasta(DATA / "tiny_db.fa")
    seqs = [*seqs[: N_SEQ - 1], seqs[N_SEQ - 1][:SHORT]]
    n_max = max(len(q) for q in seqs)
    s = np.zeros((len(seqs), n_max + tb.ML + 4), np.int64)
    for i, q in enumerate(seqs):
        s[i, 1: len(q) + 1] = alphabet.access_codes(q)
    return s, np.array([len(q) for q in seqs], np.int64), n_max


def _jax_grids(s, lens, n_max, dtype_name):
    """The JAX package's inside grids, its inside pass's multi2, A,
    B_outer and logZ, and its outside grids, as numpy."""
    dtype = jnp.dtype(dtype_name).type
    B = s.shape[0]
    t = jb.make_tables(W_SPAN, dtype=jnp.dtype(dtype_name))

    def run(s, lengths):
        g = jb.make_grids(t, s, lengths, n_max, BAND, dtype)
        ins = jb.inside_pass(t, g, n_max, BAND, B, dtype)
        A = ins[6]
        logZ = jnp.take_along_axis(A, lengths[None, :], axis=0)[0]
        Bo = jb.b_outer_scan(ins[0], g.ext_dot, n_max, BAND, B, dtype,
                             lengths)
        og = jb.make_outside_grids(t, s, lengths, n_max, BAND, dtype, g,
                                   ins[5], A, Bo, logZ)
        return g, (ins[5], A, Bo, logZ), og

    out = jax.jit(run)(jnp.asarray(s.astype(np.int32)),
                       jnp.asarray(lens.astype(np.int32)))
    return jax.tree.map(np.asarray, out)


def _ulps(a, b):
    it = _INT_VIEW[a.dtype]
    return int(np.abs(a.view(it).astype(np.int64)
                      - b.view(it).astype(np.int64)).max())


def _assert_fields(port, ref, dtype):
    assert port._fields == ref._fields
    for name, a, b in zip(ref._fields, port, ref):
        a = a.numpy()
        assert a.shape == b.shape, name
        if b.dtype == np.bool_:
            assert a.dtype == np.bool_, name
            assert np.array_equal(a, b), name
            continue
        assert a.dtype == b.dtype == dtype, name
        if name == "seed":
            assert (a >= 0).all() and (b >= 0).all()
            assert _ulps(a, b) <= SEED_ULPS, name
            assert b.max() > 0
        elif name in BULGE_SPECIALS and dtype == np.float32:
            assert (a >= 0).all() and (b >= 0).all()
            assert _ulps(a, b) <= 1, name
            assert b.max() > 0
        else:
            assert np.array_equal(a, b), name


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_grids_match_the_jax_package(inputs, dtype):
    """make_grids and make_outside_grids of the port against the JAX
    package's on the same codes, lengths and inside-pass outputs: bool
    and gathered planes exact, the float32 bulge specials within 1 ulp,
    the seed within SEED_ULPS ulps."""
    s, lens, n_max = inputs
    jg, (m2, A, Bo, logZ), jog = _jax_grids(s, lens, n_max, dtype)
    dt = tb._DTYPES[dtype]
    t = tb.make_tables(W_SPAN, dt)
    s_t, lens_t = torch.as_tensor(s), torch.as_tensor(lens)
    g = tb.make_grids(t, s_t, lens_t, n_max, BAND, dt)
    _assert_fields(g, jg, np.dtype(dtype))
    og = tb.make_outside_grids(t, s_t, lens_t, n_max, BAND, dt, g,
                               *(torch.from_numpy(np.array(x))
                                 for x in (m2, A, Bo, logZ)))
    _assert_fields(og, jog, np.dtype(dtype))
    assert g.t1_nz.any() and og.valid_int.any()
