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

import ctypes
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
                      ("access_prob_f32", "access_prob_f64",
                       "access_prob_energies_f32",
                       "access_prob_energies_f64"))


@pytest.fixture(scope="module", params=["float64", "float32"])
def planes(request):
    """The plain scans' outputs on the ragged batch in `dtype`."""
    return _planes(ab._DTYPES[request.param], W_SPAN)


@functools.lru_cache(maxsize=6)
def _planes(dtype, w_span, short=False):
    """The plain scans' outputs on the ragged batch in `dtype` at the
    maximal span `w_span` (band w_span + 2); with `short`, its second row
    cut to 3 nt and its fourth to 0 nt (a padding row)."""
    band = w_span + 2
    _names, seqs = fasta.read_fasta(DATA / "tiny_db.fa")
    seqs = [*seqs[: N_SEQ - 1], seqs[N_SEQ - 1][:SHORT]]
    if short:
        seqs[1], seqs[3] = seqs[1][:3], ""
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


# ---------------------------------------------------------------------------
# the epilogue kernel (csrc/access_prob.cu: epilogue_kernel, entry points
# access_epilogue_f32 / _f64) against accessibility_from_probabilities.
# Tolerance: the host's logf (glibc) and PyTorch's CPU log may differ by
# an ulp, and the kernel multiplies by the float32 reciprocal of 1000 where
# PyTorch's CPU divides (on the card PyTorch multiplies by it too), so each
# window energy may differ by 2 float32 ulps of its own magnitude (1 seen):
# acc by 2 ulps of |acc|, cond (the difference of the two energies at its
# window) by 2 ulps of each; where the plain version writes a zero, the
# kernel writes the same zero, sign included. On the card both call the
# same libdevice logf and agree bit for bit (tests/test_torch_gpu.py,
# chip_smoke.py [kernel]).
# ---------------------------------------------------------------------------


def _epilogue_fn(lib, dtype):
    fn = getattr(lib, "access_epilogue_f64" if dtype == torch.float64
                 else "access_epilogue_f32")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4
    return fn


def _assert_epilogue(got, ref, w):
    """got and ref [2, B, N] float32: within the tolerance above."""
    assert got.shape == ref.shape and got.dtype == torch.float32
    g, r = got.numpy().astype(np.float64), ref.numpy()
    acc, cond = r[0].astype(np.float64), r[1].astype(np.float64)
    tol_acc = 2 * np.spacing(np.abs(r[0]))
    # cond[b, y] = e_w1 - e_w at window start x = y - w + 1 (y >= w), with
    # e_w = acc[b, y - w]
    e_w = np.zeros_like(cond)
    e_w[:, w:] = acc[:, : max(acc.shape[1] - w, 0)]
    e_w1 = (cond + e_w).astype(np.float32)
    tol_cond = 2 * (np.spacing(np.abs(e_w1))
                    + np.spacing(np.abs(e_w.astype(np.float32))))
    assert np.all(np.abs(g[0] - acc) <= tol_acc)
    assert np.all(np.abs(g[1] - cond) <= tol_cond)
    zero = r == 0
    assert np.array_equal(got.numpy()[zero].view(np.uint32),
                          r[zero].view(np.uint32))
    assert np.array_equal(got.numpy() == 0, zero)


@pytest.mark.parametrize("w", [5, 2, 20])
@pytest.mark.parametrize("short", [False, True])
def test_epilogue_source_matches_plain_version(emu_lib, planes, w, short):
    """The window energies from the plain probabilities of the ragged batch
    (float64 and float32 p): acc and cond within the tolerance above, the
    zeros identical; with `short`, rows cut to 3 nt (shorter than w) and 0
    nt (a padding row)."""
    dtype, t, g, s, lens, n_max, ins, outs = planes
    p_w, p_w1 = ab.scan_probabilities(t, g, s, lens, 5, n_max, BAND, dtype,
                                      ins, outs)
    if short:
        lens = lens.clone()
        lens[1], lens[3] = 3, 0
    kT = ab._linmodel(W_SPAN).sp.kT
    ref = torch.stack(ab.accessibility_from_probabilities(p_w, p_w1, lens, w,
                                                          n_max, kT))
    got = ap._epilogue_call(_epilogue_fn(emu_lib, dtype), p_w, p_w1, lens, w,
                            n_max, kT, 0)
    assert float(ref.abs().max()) > 0
    _assert_epilogue(got, ref, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_epilogue_source_at_extreme_probabilities(emu_lib, dtype):
    """p at 0, -0, negative, denormal (in float32; in float64 also below
    float32's smallest normal and float64's denormals), at and just above
    FLT_MIN, at 1 (an energy of -0) and above 1, in every window of two
    rows of 40 and 23 nt: the clamp at FLT_MIN, the cast and the log as the
    plain version's."""
    f32min = float(np.finfo(np.float32).tiny)
    vals = [0.0, -0.0, -1.0, 1e-45, 1e-40, 5e-39, f32min,
            float(np.nextafter(np.float32(f32min), np.float32(1))), 1e-20,
            0.5, 1.0, 2.0, 3.0e-3]
    if dtype == torch.float64:
        vals += [5e-324, 1e-300, 1e-39]
    n_max, B = 40, 2
    rng = np.random.default_rng(7)
    p = rng.choice(np.asarray(vals), size=(2, n_max + 2, B))
    p_w, p_w1 = (torch.as_tensor(x, dtype=dtype).contiguous() for x in p)
    lens = torch.tensor([40, 23], dtype=torch.int64)
    kT = ab._linmodel(W_SPAN).sp.kT
    for w in (5, 2):
        ref = torch.stack(ab.accessibility_from_probabilities(
            p_w, p_w1, lens, w, n_max, kT))
        got = ap._epilogue_call(_epilogue_fn(emu_lib, dtype), p_w, p_w1,
                                lens, w, n_max, kT, 0)
        assert bool(torch.isfinite(ref).all())
        _assert_epilogue(got, ref, w)
        assert bool((torch.signbit(got) == torch.signbit(ref)).all())


def _epilogue_inputs():
    n_max, B = 30, 3
    rng = np.random.default_rng(0)
    p_w, p_w1 = (torch.as_tensor(rng.random((n_max + 2, B)),
                                 dtype=torch.float32) for _ in range(2))
    lens = torch.tensor([30, 12, 0], dtype=torch.int64)
    return [p_w, p_w1, lens, 5, n_max, 616.0]


@pytest.mark.parametrize("bad", ["dtype", "p_w1_dtype", "shape", "contiguous",
                                 "lengths_dtype", "lengths", "w", "device"])
def test_epilogue_wrapper_rejects_bad_inputs(monkeypatch, bad):
    """accessibility raises ValueError before it dispatches (the plain
    version is never called) on p of another dtype (float16, or p_w1 not
    p_w's), shape or layout, lengths not int64 or past n_max, w < 1 or a
    tensor on another device; on good CPU inputs it returns the plain
    version's acc and cond stacked."""
    args = _epilogue_inputs()
    got = ap.accessibility(*args)
    ref = ab.accessibility_from_probabilities(*args)
    assert got.shape == (2, 3, 30)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    if bad == "dtype":
        args[0], args[1] = args[0].half(), args[1].half()
    elif bad == "p_w1_dtype":
        args[1] = args[1].double()
    elif bad == "shape":
        args[1] = args[1][:-1]
    elif bad == "contiguous":
        args[0] = args[0].t().contiguous().t()
    elif bad == "lengths_dtype":
        args[2] = args[2].int()
    elif bad == "lengths":
        args[2] = args[2] + 5
    elif bad == "w":
        args[3] = 0
    else:
        args[2] = args[2].to("meta")

    def refuse(*_a, **_k):
        raise AssertionError("the plain version ran on refused inputs")

    monkeypatch.setattr(ab, "accessibility_from_probabilities", refuse)
    with pytest.raises(ValueError):
        ap.accessibility(*args)


# ---------------------------------------------------------------------------
# the window energies written by the sum launch (entry points
# access_prob_energies_f32 / _f64), the main path's form: against the plain versions (scan_probabilities, then
# accessibility_from_probabilities): in float64 within _assert_epilogue's
# tolerance (the kernel's p_w and p_w1 round to the plain version's float32
# values there), in float32 within the file's energy bound (the pass sums
# some terms in another order); against accessibility_from_probabilities on
# the kernel's own p_w and p_w1 within _assert_epilogue's tolerance in
# both; bit for bit with the epilogue kernel on those p_w and p_w1 (one
# compiler, one logf); p_w and p_w1, where asked for, bit for bit with the
# two-launch form's; and the same energies where they are not asked for.
# ---------------------------------------------------------------------------


def _emu_energies(lib, dtype, g, s, lens, w, n_max, ins, outs, band=BAND,
                  **kw):
    fn = getattr(lib, "access_prob_energies_f64" if dtype == torch.float64
                 else "access_prob_energies_f32")
    kT = ab._linmodel(band - 2).sp.kT
    return ap._energies_call(fn, g, s, lens, w, n_max, band, dtype, ins,
                             outs, kT, 0, **kw)


@pytest.mark.parametrize("w,logz,kw", [
    (5, None, {"probs": True}),
    (5, None, {}),
    (2, None, {}),
    (2, None, {"probs": True}),
    (20, None, {"probs": True}),
    (20, None, {}),
    (5, 700.0, {"probs": True}),
    (5, 400.0, {}),
    (5, None, {"staged": False, "threads": 64}),
    (5, None, {"threads": 96, "tile": 6, "probs": True}),
    (5, None, {"short": True}),
    (2, None, {"short": True, "probs": True}),
])
def test_energies_source_matches_plain_versions(emu_lib, planes, w, logz,
                                                kw):
    """The energies of the sum launch against the plain versions and the
    epilogue kernel on the two-launch form's p_w and p_w1, as the section
    above says, at w = 5, 2 and 20, with logZ moved to +-700 (the log arm)
    and +-400 (the linear arm), the window kernel unstaged at 64 threads
    and at 96 threads in tiles of 6, and on the batch with rows of 3 nt
    and 0 nt (`short`); with `probs`, p_w and p_w1 asked for too."""
    kw = dict(kw)
    short = kw.pop("short", False)
    dtype, t, g, s, lens, n_max, ins, outs = (
        _planes(planes[0], W_SPAN, True) if short else planes)
    if logz is not None:
        ins = _moved(ins, lens, logz)
    geometry = dict(tile=kw.pop("tile", EMU_TILE),
                    threads=kw.pop("threads", EMU_THREADS),
                    staged=kw.pop("staged", True))
    got = _emu_energies(emu_lib, dtype, g, s, lens, w, n_max, ins, outs,
                        **kw, **geometry)
    two = _emu(emu_lib, dtype, g, s, lens, w, n_max, ins, outs, **geometry)
    if kw.get("probs"):
        got, p_w, p_w1 = got
        assert torch.equal(p_w, two[0]) and torch.equal(p_w1, two[1])
    kT = ab._linmodel(W_SPAN).sp.kT
    epi = ap._epilogue_call(_epilogue_fn(emu_lib, dtype), *two, lens, w,
                            n_max, kT, 0)
    assert torch.equal(got.view(torch.int32), epi.view(torch.int32))
    own = torch.stack(ab.accessibility_from_probabilities(*two, lens, w,
                                                          n_max, kT))
    _assert_epilogue(got, own, w)
    ref = torch.stack(ab.accessibility_from_probabilities(
        *ab.scan_probabilities(t, g, s, lens, w, n_max, BAND, dtype, ins,
                               outs), lens, w, n_max, kT))
    assert float(ref.abs().max()) > 0 and bool(torch.isfinite(got).all())
    if dtype == torch.float64:
        _assert_epilogue(got, ref, w)
    else:
        assert float((got.double() - ref.double()).abs().max()) <= TOL[
            dtype][1]
    if short:  # no window fits in 0 nt, nor one of w > 3 in 3 nt
        assert bool((got[:, 3] == 0).all())
        assert w <= 3 or bool((got[:, 1] == 0).all())


@pytest.mark.parametrize("w", [2, 20])
def test_energies_source_row_bits_do_not_depend_on_the_batch(emu_lib, planes,
                                                             w):
    """Rows 0 and 3 (the 40-nt one) alone in a batch of two, and rows 0, 1
    and 3 in a batch of three (whose blocks of the sum launch end inside a
    window's rows): the same energies, bit for bit, as in the batch of
    four, at w = 2 and 20."""
    dtype, _t, g, s, lens, n_max, ins, outs = planes
    geometry = dict(tile=EMU_TILE, threads=EMU_THREADS)
    full = _emu_energies(emu_lib, dtype, g, s, lens, w, n_max, ins, outs,
                         **geometry)
    for rows in ([0, N_SEQ - 1], [0, 1, N_SEQ - 1]):
        rows = torch.tensor(rows)

        def pick(x):
            return x.index_select(1, rows).contiguous()

        part = _emu_energies(emu_lib, dtype, g._replace(hpW=pick(g.hpW)),
                             s[rows].contiguous(), lens[rows].contiguous(),
                             w, n_max, tuple(pick(x) for x in ins),
                             tuple(pick(x) for x in outs), **geometry)
        assert torch.equal(full.index_select(1, rows), part)


@pytest.mark.parametrize("null", ["acc", "lengths", "p_w1"])
def test_energies_entry_point_refuses_a_null_pointer(emu_lib, planes,
                                                     monkeypatch, null):
    """A null acc or lengths, or p_w given without p_w1: the entry point
    returns a CUDA error before it launches anything, and the wrapper
    raises."""
    dtype, _t, g, s, lens, n_max, ins, outs = planes
    launch = ap._launch

    def drop(fn, ptrs, *rest):
        ptrs = list(ptrs)
        ptrs[{"acc": 27, "lengths": 26, "p_w1": 25}[null]] = 0
        launch(fn, ptrs, *rest)

    monkeypatch.setattr(ap, "_launch", drop)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _emu_energies(emu_lib, dtype, g, s, lens, 5, n_max, ins, outs,
                      probs=True)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "codes",
                                 "lengths_dtype", "lengths", "window",
                                 "device"])
def test_energies_wrapper_rejects_bad_inputs(monkeypatch, bad):
    """window_energies raises ValueError before it dispatches (neither
    plain version is called) on a plane of another dtype, shape or layout,
    codes not int64, lengths not int64 or past n_max, w < 1 or lengths on
    another device; on good CPU inputs it returns the plain versions'
    acc and cond stacked."""
    dtype, t, g, s, lens, n_max, ins, outs = _planes(torch.float32, W_SPAN)
    kT = ab._linmodel(W_SPAN).sp.kT
    w = 5
    got = ap.window_energies(t, g, s, lens, w, n_max, BAND, dtype, ins,
                             outs, kT)
    ref = ab.accessibility_from_probabilities(
        *ab.scan_probabilities(t, g, s, lens, w, n_max, BAND, dtype, ins,
                               outs), lens, w, n_max, kT)
    assert got.shape == (2, N_SEQ, n_max) and got.dtype == torch.float32
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    if bad == "dtype":
        outs = (*outs[:4], outs[4].double())
    elif bad == "shape":
        ins = (*ins[:6], ins[6][:-1], ins[7])
    elif bad == "contiguous":
        ins = (ins[0].transpose(0, 1).contiguous().transpose(0, 1),
               *ins[1:])
    elif bad == "codes":
        s = s.int()
    elif bad == "lengths_dtype":
        lens = lens.int()
    elif bad == "lengths":
        lens = lens + n_max
    elif bad == "window":
        w = 0
    else:
        lens = lens.to("meta")

    def refuse(*_a, **_k):
        raise AssertionError("a plain version ran on refused inputs")

    monkeypatch.setattr(ab, "scan_probabilities", refuse)
    monkeypatch.setattr(ab, "accessibility_from_probabilities", refuse)
    with pytest.raises(ValueError):
        ap.window_energies(t, g, s, lens, w, n_max, BAND, dtype, ins, outs,
                           kT)
