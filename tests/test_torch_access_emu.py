"""The accessibility scan kernels' sources (csrc/access_inside.cu: the
inside pass with both exterior scans; csrc/access_outside.cu: the outside
pass), compiled by g++ against tests/cuda_emu/ (one std::thread per CUDA
thread), against their plain PyTorch versions in
accessibility/batched.py, on the first three tiny_db.fa sequences (292,
257 and 271 nt) and the first 40 nt of the fourth: a ragged batch with a
sequence shorter than the band, so that the outside kernel's multi1 ring
reads rows before column 0.

Tolerances:
- the stacked planes, A and B: relative 1e-12 in float64 (every term of
  every sum is a nonnegative Boltzmann weight, so the kernels differ from
  the plain versions only by the order of their sums) and 1e-4 in float32;
- the window energies -kT log p / 1000 through probability_pass, the whole
  kernel chain against the whole plain chain: 1e-9 kcal/mol in float64 and
  2e-3 in float32 (the repo's float32 bound).

The emulated CTA has 128 threads (four warps; the card runs 256), so warp
0's exterior steps and the item loops that span warps are exercised; the
outside kernel also runs at 256 threads in float64 and float32. This
runs the kernels' own arithmetic, indexing and barriers on a machine
without a card; it does not replace the comparison on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from priblast_tpu_torch.accessibility import batched as ab
from priblast_tpu_torch.ops import access_scan as acs
from priblast_tpu_torch.utils import alphabet, fasta
from test_torch_kernel_emu import _emu_build

# one intra-op thread: PyTorch's idle workers would compete with the
# emulated CUDA threads for the host's cores
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"
W_SPAN, D, N_SEQ, EMU_THREADS = 70, 5, 4, 128
SHORT = 40  # nt of the last sequence, shorter than the band
BAND = W_SPAN + 2
TOL = {torch.float64: (1e-12, 1e-9), torch.float32: (1e-4, 2e-3)}
PLANES = ("stem", "stem_m", "stem_a", "multi", "multi1", "multi2", "A", "B")
OUT_PLANES = ("bse", "bse_m", "bse_a", "b_multi", "b_multi2")


@pytest.fixture(scope="module")
def emu_libs(tmp_path_factory):
    d = tmp_path_factory.mktemp("access_emu")
    return (_emu_build(d, acs.SRC_INSIDE,
                       ("access_inside_f32", "access_inside_f64")),
            _emu_build(d, acs.SRC_OUTSIDE,
                       ("access_outside_f32", "access_outside_f64")))


@pytest.fixture(scope="module")
def tiny_batch():
    _names, seqs = fasta.read_fasta(DATA / "tiny_db.fa")
    seqs = [*seqs[: N_SEQ - 1], seqs[N_SEQ - 1][:SHORT]]
    n_max = max(len(s) for s in seqs)
    s = np.zeros((len(seqs), n_max + ab.ML + 4), np.int64)
    for i, q in enumerate(seqs):
        s[i, 1: len(q) + 1] = alphabet.access_codes(q)
    lens = torch.tensor([len(q) for q in seqs], dtype=torch.int64)
    return torch.as_tensor(s), lens, n_max


def _energies(t, g, s, lens, n_max, dtype, ins, outs):
    """Window energies -kT log p_w / 1000 (float64) of every sequence's
    windows x = 1 .. n - D + 1, from the scans' outputs."""
    p = ab.scan_probabilities(t, g, s, lens, D, n_max, BAND, dtype, ins,
                              outs)[0].double().numpy()
    kT = ab._linmodel(W_SPAN).sp.kT
    return [-kT * np.log(p[1: n - D + 2, i]) / 1000
            for i, n in enumerate(lens.tolist())]


@pytest.fixture(scope="module", params=["float64", "float32"])
def runs(request, emu_libs, tiny_batch):
    """The plain chain and the emulated kernel chain in `dtype`: the
    inside kernel on the plain chain's grids, the outside kernel on the
    outside grids and multi1 made from the inside kernel's outputs (and
    outside_pass on those same inputs), and both chains' window
    energies."""
    dtype = ab._DTYPES[request.param]
    lib_in, lib_out = emu_libs
    sfx = "f64" if dtype == torch.float64 else "f32"
    f_in = getattr(lib_in, f"access_inside_{sfx}")
    f_out = getattr(lib_out, f"access_outside_{sfx}")
    s, lens, n_max = tiny_batch
    t = ab.make_tables(W_SPAN, dtype)
    g = ab.make_grids(t, s, lens, n_max, BAND, dtype)

    def outside_inputs(ins):
        return ab.outside_inputs(t, s, lens, n_max, BAND, dtype, g, ins)

    plain = acs.inside_scan(t, g, lens, n_max, BAND, dtype)
    plain_out = acs.outside_scan(t, *outside_inputs(plain), n_max, BAND,
                                 dtype)
    emu = acs._inside_call(f_in, t, g, lens, n_max, BAND, dtype, 0,
                           EMU_THREADS)
    og_e, m1_e = outside_inputs(emu)
    emu_out = acs._outside_call(f_out, t, og_e, m1_e, n_max, BAND, dtype, 0,
                                EMU_THREADS)
    same_out = acs.outside_scan(t, og_e, m1_e, n_max, BAND, dtype)
    e_plain = _energies(t, g, s, lens, n_max, dtype, plain, plain_out)
    e_emu = _energies(t, g, s, lens, n_max, dtype, emu, emu_out)
    return dtype, plain, emu, same_out, emu_out, e_plain, e_emu


def _assert_close(got, ref, rtol, dtype, name):
    """|got - ref| <= rtol |ref|, compared in float64; values below the
    dtype's smallest normal compare absolutely."""
    assert got.dtype == ref.dtype == dtype and got.shape == ref.shape, name
    err = (got.double() - ref.double()).abs()
    lim = rtol * ref.double().abs() + torch.finfo(dtype).tiny
    assert bool((err <= lim).all()), (
        f"{name}: max rel err {float((err / lim).max()) * rtol:.3g}")


def test_inside_kernel_source_matches_plain_version(runs):
    """Six stacked planes, A and B of the inside kernel against
    inside_pass + b_outer_scan on the same grids."""
    dtype, plain, emu, *_ = runs
    for name, got, ref in zip(PLANES, emu, plain):
        _assert_close(got, ref, TOL[dtype][0], dtype, name)
    assert float(plain[0].abs().max()) > 0      # the sequences do fold
    assert float(plain[7].abs().max()) > 1       # B is not trivially 0


def test_outside_kernel_source_matches_plain_version(runs):
    """Five stacked planes of the outside kernel against outside_pass, on
    the same outside grids and multi1."""
    dtype, _plain, _emu, same_out, emu_out, *_ = runs
    for name, got, ref in zip(OUT_PLANES, emu_out, same_out):
        _assert_close(got, ref, TOL[dtype][0], dtype, name)
    assert float(same_out[4].abs().max()) > 0


def test_kernel_chain_window_energies_match_plain_chain(runs):
    """Window energies through probability_pass: both kernels (outside
    grids from the inside kernel's outputs) against the plain chain."""
    dtype, *_, e_plain, e_emu = runs
    assert len(e_plain) == N_SEQ
    for ep, ee in zip(e_plain, e_emu):
        assert np.isfinite(ee).all()
        assert np.abs(ee - ep).max() <= TOL[dtype][1]


@pytest.fixture(scope="module", params=["float64", "float32"])
def runs_256(request, emu_libs, tiny_batch):
    """The outside kernel at 256 threads per CTA on the plain chain's
    outside inputs, outside_pass on the same inputs, and both chains'
    window energies (plain inside planes, then either outside pass)."""
    dtype = ab._DTYPES[request.param]
    sfx = "f64" if dtype == torch.float64 else "f32"
    f_out = getattr(emu_libs[1], f"access_outside_{sfx}")
    s, lens, n_max = tiny_batch
    t = ab.make_tables(W_SPAN, dtype)
    g = ab.make_grids(t, s, lens, n_max, BAND, dtype)
    ins = acs.inside_scan(t, g, lens, n_max, BAND, dtype)
    og, m1 = ab.outside_inputs(t, s, lens, n_max, BAND, dtype, g, ins)
    plain_out = acs.outside_scan(t, og, m1, n_max, BAND, dtype)
    emu_out = acs._outside_call(f_out, t, og, m1, n_max, BAND, dtype, 0, 256)
    return (dtype, plain_out, emu_out,
            _energies(t, g, s, lens, n_max, dtype, ins, plain_out),
            _energies(t, g, s, lens, n_max, dtype, ins, emu_out))


def test_outside_kernel_at_256_threads_matches_plain_version(runs_256):
    """Five stacked planes at 256 threads (eight warps) against
    outside_pass, short sequence included."""
    dtype, plain_out, emu_out, *_ = runs_256
    for name, got, ref in zip(OUT_PLANES, emu_out, plain_out):
        _assert_close(got, ref, TOL[dtype][0], dtype, name)
    assert float(plain_out[4][:, N_SEQ - 1].abs().max()) > 0


def test_outside_kernel_at_256_threads_window_energies(runs_256):
    """Window energies with the outside kernel at 256 threads against the
    plain chain, the short sequence's included."""
    dtype, *_, e_plain, e_emu = runs_256
    assert len(e_emu) == N_SEQ and len(e_emu[-1]) == SHORT - D + 1
    for ep, ee in zip(e_plain, e_emu):
        assert np.isfinite(ee).all()
        assert np.abs(ee - ep).max() <= TOL[dtype][1]
