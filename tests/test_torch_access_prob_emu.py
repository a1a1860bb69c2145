"""The probability kernel's source (csrc/access_prob.cu: make_prob_grids,
probability_pass and the sum of their terms, as two launches), compiled
by g++ against tests/cuda_emu/ (one std::thread per CUDA thread), against
its plain PyTorch version, accessibility/batched.py:scan_probabilities,
on the inside and outside planes of the first three tiny_db.fa sequences
(292, 257 and 271 nt) and the first 40 nt of the fourth (shorter than the
band): a ragged batch.

Tolerances:
- p_w and p_w1: relative 1e-12 in float64 (every term of every sum is a
  nonnegative weight, so the kernel differs from the plain version only
  by the order of some sums) and 1e-4 in float32, values below the
  dtype's smallest normal compared absolutely;
- the window energies -kT log p / 1000 (accessibility_from_probabilities):
  1e-9 kcal/mol in float64 and 2e-3 in float32 (the repo's float32 bound).

Cases: w = 5 (the CLI's default) and w = 2 (the small-loop specials,
which spread only where w <= 2), and both arms of the linear / log branch
of the bulge and interior windows (batched.py:909-914): the same planes
with A moved per row so that logZ lies past 690 on both sides (+700,
-700), the log arm, without a 3,000-nt sequence; and at +400 and -400,
the linear arm, where at +400 the clamp at e^(128 ln 2 - logZ) binds; a
maximal span of 40 (band 42) and w = 20 (11 loop sizes), since the window
kernel's split of a column's spans over its lanes depends on (w, band).
The window kernel runs with its stem rows staged in shared memory (tiles
of 16 columns, so that a sequence spans several CTAs), from device memory
at 64 threads, and at 96 threads in tiles of 6 columns (a warp with no
columns, a part-filled one): the same bits as the default's in each. A
row gets the same bits in a batch of two rows.
This runs the kernel's own arithmetic, indexing and warp protocol on a
machine without a card; the card's comparison is tests/test_torch_gpu.py
and chip_smoke.py.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from priblast_tpu_torch.accessibility import batched as ab
from priblast_tpu_torch.ops import access_prob as ap
from priblast_tpu_torch.ops import access_scan as acs
from priblast_tpu_torch.utils import alphabet, fasta
from test_torch_access_emu import _assert_close
from test_torch_kernel_emu import _emu_build

# one intra-op thread: PyTorch's idle workers would compete with the
# emulated CUDA threads for the host's cores
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"
W_SPAN, N_SEQ, SHORT = 70, 4, 40
BAND = W_SPAN + 2
TOL = {torch.float64: (1e-12, 1e-9), torch.float32: (1e-4, 2e-3)}
EMU_THREADS, EMU_TILE = 128, 16


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    return _emu_build(tmp_path_factory.mktemp("access_prob_emu"), ap.SRC,
                      ("access_prob_f32", "access_prob_f64"))


@pytest.fixture(scope="module", params=["float64", "float32"])
def planes(request):
    """The plain scans' outputs on the ragged batch in `dtype`."""
    return _planes(ab._DTYPES[request.param], W_SPAN)


@functools.lru_cache(maxsize=4)
def _planes(dtype, w_span):
    """The plain scans' outputs on the ragged batch in `dtype` at the
    maximal span `w_span` (band w_span + 2)."""
    band = w_span + 2
    _names, seqs = fasta.read_fasta(DATA / "tiny_db.fa")
    seqs = [*seqs[: N_SEQ - 1], seqs[N_SEQ - 1][:SHORT]]
    n_max = max(len(q) for q in seqs)
    s = np.zeros((len(seqs), n_max + ab.ML + 4), np.int64)
    for i, q in enumerate(seqs):
        s[i, 1: len(q) + 1] = alphabet.access_codes(q)
    s = torch.as_tensor(s)
    lens = torch.tensor([len(q) for q in seqs], dtype=torch.int64)
    t = ab.make_tables(w_span, dtype)
    g = ab.make_grids(t, s, lens, n_max, band, dtype)
    ins = acs.inside_scan(t, g, lens, n_max, band, dtype)
    og, m1 = ab.outside_inputs(t, s, lens, n_max, band, dtype, g, ins)
    outs = acs.outside_scan(t, og, m1, n_max, band, dtype)
    return dtype, t, g, s, lens, n_max, ins, outs


def _moved(ins, lens, z):
    """`ins` with A moved per row so that logZ = +z on even rows and -z on
    odd ones."""
    A = ins[6]
    logZ = A.gather(0, lens[None, :])[0]
    target = torch.tensor([z if i % 2 == 0 else -z
                           for i in range(A.shape[1])], dtype=A.dtype)
    return (*ins[:6], (A + (target - logZ)[None, :]).contiguous(), ins[7])


def _emu(lib, dtype, g, s, lens, w, n_max, ins, outs, band=BAND, **kw):
    fn = getattr(lib, "access_prob_f64" if dtype == torch.float64
                 else "access_prob_f32")
    return ap._prob_call(fn, g, s, lens, w, n_max, band, dtype, ins, outs,
                         0, **kw)


def _energies(p_w, p_w1, lens, w, n_max, w_span=W_SPAN):
    kT = ab._linmodel(w_span).sp.kT
    return ab.accessibility_from_probabilities(p_w, p_w1, lens, w, n_max, kT)


@pytest.mark.parametrize("w,logz,kw", [
    (5, None, {}),
    (2, None, {}),
    (5, 700.0, {}),
    (5, 400.0, {}),
    (5, None, {"staged": False, "threads": 64}),
    (5, None, {"w_span": 40}),
    (20, None, {}),
    (5, None, {"threads": 96, "tile": 6}),
])
def test_probability_kernel_source_matches_plain_version(emu_lib, planes, w,
                                                         logz, kw):
    """p_w, p_w1 and the window energies of the kernel against
    scan_probabilities on the same planes (logZ moved to +-logz where
    given; at the maximal span kw["w_span"] where given); where the threads,
    the tile or the staging differ from the default's, the same bits as
    the default's."""
    w_span = kw.get("w_span", W_SPAN)
    band = w_span + 2
    dtype, t, g, s, lens, n_max, ins, outs = (
        planes if w_span == W_SPAN else _planes(planes[0], w_span))
    if logz is not None:
        ins = _moved(ins, lens, logz)
        logZ = ins[6].gather(0, lens[None, :])[0]
        assert bool((logZ.abs() == logz).all())
    ref = ab.scan_probabilities(t, g, s, lens, w, n_max, band, dtype, ins,
                                outs)
    got = _emu(emu_lib, dtype, g, s, lens, w, n_max, ins, outs, band,
               tile=kw.get("tile", EMU_TILE),
               threads=kw.get("threads", EMU_THREADS),
               staged=kw.get("staged", True))
    if kw.keys() & {"tile", "threads", "staged"}:
        default = _emu(emu_lib, dtype, g, s, lens, w, n_max, ins, outs, band,
                       tile=EMU_TILE, threads=EMU_THREADS)
        for a, b in zip(got, default):
            assert torch.equal(a, b)
    rtol, etol = TOL[dtype]
    for name, a, b in zip(("p_w", "p_w1"), got, ref):
        # rows 1 .. N are the window starts (row 0 reads A at x - 1 = -1
        # as 0, which overflows where A was moved)
        _assert_close(a[1: n_max + 1], b[1: n_max + 1], rtol, dtype, name)
        assert float(b[1: n_max + 1].max()) > 0
        assert bool((a[n_max + 1] == 0).all())
    for name, a, b in zip(("acc", "cond"),
                          _energies(*got, lens, w, n_max, w_span),
                          _energies(*ref, lens, w, n_max, w_span)):
        assert bool(torch.isfinite(a).all()), name
        assert float((a.double() - b.double()).abs().max()) <= etol, name


def test_probability_kernel_source_row_bits_do_not_depend_on_the_batch(
        emu_lib, planes):
    """Rows 0 and 3 (the 40-nt one) alone in a batch of two: the same bits
    as in the batch of four, at w = 2 (every term, specials included)."""
    dtype, _t, g, s, lens, n_max, ins, outs = planes
    rows = torch.tensor([0, N_SEQ - 1])

    def pick(x):
        return x.index_select(1, rows).contiguous()

    full = _emu(emu_lib, dtype, g, s, lens, 2, n_max, ins, outs,
                tile=EMU_TILE, threads=EMU_THREADS)
    part = _emu(emu_lib, dtype, g._replace(hpW=pick(g.hpW)),
                s[rows].contiguous(), lens[rows].contiguous(), 2, n_max,
                tuple(pick(x) for x in ins), tuple(pick(x) for x in outs),
                tile=EMU_TILE, threads=EMU_THREADS)
    for a, b in zip(full, part):
        assert torch.equal(pick(a), b)


def test_prob_lanes_counts_every_term_once():
    """chip_smoke.prob_lanes, the window kernel's split of a column's
    interior-loop and bulge terms over its 8 lanes: every term once (the
    lanes' sum equals a count by loop size and side), no lane above the
    slots it runs; and one lane per loop size, counted from its longest
    lane (at the CLI's defaults, 17,667 terms a side against 32 x 1,417)."""
    import chip_smoke

    for band, w in ((72, 5), (72, 2), (42, 5), (72, 20), (102, 5)):
        lanes = chip_smoke.prob_lanes(band, w, ab.ML)
        per_u = [sum(min(ab.ML - u, j) for j in range(1, band - u))
                 + (band - u) * (u >= 2) for u in range(w, ab.ML + 1)]
        assert lanes["mean_terms"] * 8 == 2 * sum(per_u)
        assert lanes["max_terms"] <= lanes["slots"]
        assert 0 < lanes["efficiency"] <= 1
    default = chip_smoke.prob_lanes(BAND, 5, ab.ML)
    assert default["one_per_u"] == 17667 / (32 * 1417)
    assert default["efficiency"] > default["one_per_u"]
