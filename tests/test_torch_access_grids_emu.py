"""The weight grids' kernel source (csrc/access_grids.cu: make_grids and
make_outside_grids as two launches), compiled by g++ against
tests/cuda_emu/ (one std::thread per CUDA thread), against its plain
PyTorch versions, accessibility/batched.py:make_grids and
make_outside_grids, plane by plane, on the first three tiny_db.fa
sequences (292, 257 and 271 nt) and the first 40 nt of the fourth, which
is shorter than the band: a ragged batch, so that cells read codes past a
row's end and before its start. The outside launch takes the inside
scan's multi2, A, B and logZ of the same batch.

Tolerances: every plane bit for bit (bool planes equal, every gathered
weight and product the same float), but the seed exp(A + B - logZ +
d lsig), within 2 ulps: the host's expf / exp runs here, as the card's
runs there, and may round otherwise than PyTorch's exp.

Cases: float32 and float64, at band 72 (the CLI's span of 70) and band 42;
the inside launch in a few CTAs that stride over the cells and in a
thread per cell; the outside launch in CTAs of one row and a tile of
columns, at the wrapper's geometry and at others: tiles of 5, 7, 16 and
100 columns, so that 293 columns (N + 1 of the longest row) are never a
multiple of the tile and the last tile straddles the end, the first
tiles hold columns q < band (p = q - d < 0), the last ones cells with
q + d > N, and the 40-nt row is shorter than the band; one row alone
against the same row in a batch of two. This runs the kernel's own
arithmetic, indexing and staging on a machine without a card; the card's
comparison is tests/test_torch_gpu.py and chip_smoke.py.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from priblast_tpu_torch.accessibility import batched as ab
from priblast_tpu_torch.ops import access_grids as ag
from priblast_tpu_torch.ops import access_scan as acs
from priblast_tpu_torch.utils import alphabet, fasta
from test_torch_kernel_emu import _emu_build

# one intra-op thread: PyTorch's idle workers would compete with the
# emulated CUDA threads for the host's cores
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"
N_SEQ, SHORT = 4, 40
# the emulated launches: CTAs of 64 threads; inside two, which stride over
# the cells, outside each a row and 5 columns
EMU_THREADS, EMU_BLOCKS, EMU_TILE = 64, 2, 5
# other (threads per CTA, columns per CTA) of the launch
GEOMETRIES = [(96, 7), (32, 100)]
SEED_ULPS = 2
_INT_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64}


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    return _emu_build(tmp_path_factory.mktemp("access_grids_emu"), ag.SRC,
                      tuple(f"access_grids_{side}_{dt}"
                            for side in ("inside", "outside")
                            for dt in ("f32", "f64")))


@functools.lru_cache(maxsize=4)
def _batch(dtype, band):
    """The ragged batch's codes and lengths, its plain inside grids and the
    inside scan's outputs (plain) in `dtype` at `band`."""
    _names, seqs = fasta.read_fasta(DATA / "tiny_db.fa")
    seqs = [*seqs[: N_SEQ - 1], seqs[N_SEQ - 1][:SHORT]]
    n_max = max(len(q) for q in seqs)
    s = np.zeros((len(seqs), n_max + ab.ML + 4), np.int64)
    for i, q in enumerate(seqs):
        s[i, 1: len(q) + 1] = alphabet.access_codes(q)
    s = torch.as_tensor(s)
    lens = torch.tensor([len(q) for q in seqs], dtype=torch.int64)
    t = ab.make_tables(band - 2, dtype)
    g = ab.make_grids(t, s, lens, n_max, band, dtype)
    ins = acs.inside_scan(t, g, lens, n_max, band, dtype)
    return t, s, lens, n_max, g, ins


def _outside_args(lens, ins):
    """(multi2, A, B, logZ) of the inside scan's outputs."""
    logZ = ins[6].gather(0, lens[None, :])[0]
    return ins[5], ins[6], ins[7], logZ


def _emu(lib, side, dtype, s, lens, n_max, band, outside=None, **kw):
    fn = getattr(lib, f"access_grids_{side}_"
                 f"{'f64' if dtype == torch.float64 else 'f32'}")
    return ag._grids_call(fn, s, lens, n_max, band, dtype, 0, outside,
                          **{"threads": EMU_THREADS, "blocks": EMU_BLOCKS,
                             "tile": EMU_TILE, **kw})


def _ulps(a, b):
    """Largest distance in ulps of two tensors of nonnegative floats."""
    it = _INT_VIEW[a.dtype]
    return int((a.view(it).long() - b.view(it).long()).abs().max())


def _assert_planes(got, ref, dtype):
    assert type(got) is type(ref)
    for name, a, b in zip(ref._fields, got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.is_contiguous(), name
        if name == "seed":
            assert b.dtype == dtype and bool((b >= 0).all())
            assert _ulps(a, b) <= SEED_ULPS, name
        else:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("band", [72, 42])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_grids_kernel_source_matches_plain_versions(emu_lib, dtype, band):
    """Both launches against make_grids and make_outside_grids, plane by
    plane: bit for bit, the seed within 2 ulps; the planes are not
    trivial (pairs form, some of the short row's cells lie past its
    end)."""
    dt = ab._DTYPES[dtype]
    t, s, lens, n_max, g, ins = _batch(dt, band)
    got = _emu(emu_lib, "inside", dt, s, lens, n_max, band)
    _assert_planes(got, g, dt)
    assert bool(g.t1_nz.any()) and bool(g.validC.any())
    args = _outside_args(lens, ins)
    og = ab.make_outside_grids(t, s, lens, n_max, band, dt, g, *args)
    got_o = _emu(emu_lib, "outside", dt, s, lens, n_max, band,
                 (g, *args[1:], args[0]))
    _assert_planes(got_o, og, dt)
    assert got_o.dangle_pq is g.dangle_ij
    assert float(og.seed.max()) > 0 and float(og.spo22.abs().max()) > 0


def test_grids_kernel_source_one_thread_per_cell(emu_lib):
    """The wrapper's launch geometry (its threads per CTA and tile), on
    rows 0 and 3 (the 40-nt one) in float32: the plain versions'
    planes."""
    dt, band = torch.float32, 42
    t, s, lens, n_max, _g, ins = _batch(dt, band)
    rows = torch.tensor([0, N_SEQ - 1])
    s2, lens2 = s[rows].contiguous(), lens[rows].contiguous()
    ins2 = tuple(x.index_select(1, rows).contiguous() for x in ins)
    g2 = ab.make_grids(t, s2, lens2, n_max, band, dt)
    geometry = {"threads": ag.THREADS, "blocks": 0, "tile": ag.TILE}
    _assert_planes(_emu(emu_lib, "inside", dt, s2, lens2, n_max, band,
                        **geometry), g2, dt)
    args = _outside_args(lens2, ins2)
    _assert_planes(_emu(emu_lib, "outside", dt, s2, lens2, n_max, band,
                        (g2, *args[1:], args[0]), **geometry),
                   ab.make_outside_grids(t, s2, lens2, n_max, band, dt, g2,
                                         *args), dt)


def _row_alone_and_in_a_pair(lib, dtype, **geometry):
    """Row 3 (40 nt) alone, and with row 1 in a batch of two: the same bits
    in every plane of both launches."""
    dt, band = ab._DTYPES[dtype], 72
    _t, s, lens, n_max, g, ins = _batch(dt, band)

    def run(rows):
        idx = torch.tensor(rows)
        sub = tuple(x.index_select(1, idx).contiguous() for x in ins)
        s_r, l_r = s[idx].contiguous(), lens[idx].contiguous()
        gi = _emu(lib, "inside", dt, s_r, l_r, n_max, band, **geometry)
        args = _outside_args(l_r, sub)
        go = _emu(lib, "outside", dt, s_r, l_r, n_max, band,
                  (gi, *args[1:], args[0]), **geometry)
        return gi, go

    alone, pair = run([N_SEQ - 1]), run([1, N_SEQ - 1])
    for a_planes, p_planes in zip(alone, pair):
        for name, a, p in zip(a_planes._fields, a_planes, p_planes):
            assert torch.equal(a[:, 0], p[:, 1]), name


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_grids_kernel_source_row_alone_equals_row_in_a_pair(emu_lib, dtype):
    """Row 3 (40 nt) alone, and with row 1 in a batch of two: the same bits
    in every plane of both launches."""
    _row_alone_and_in_a_pair(emu_lib, dtype)


@pytest.mark.parametrize("threads,tile", GEOMETRIES)
def test_grids_kernel_source_row_alone_in_other_tiles(emu_lib, threads,
                                                      tile):
    """The same at other geometries: a row's bits do not depend on the
    batch's other row, whatever the tile."""
    _row_alone_and_in_a_pair(emu_lib, "float32", threads=threads, tile=tile)


@pytest.mark.parametrize("threads,tile", GEOMETRIES)
@pytest.mark.parametrize("band", [72, 42])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_grids_kernel_source_tiles_match_plain_versions(emu_lib, dtype, band,
                                                         threads, tile):
    """Both launches at other geometries against make_grids and
    make_outside_grids, plane by plane (bit for bit, the seed within 2
    ulps): N + 1 not a multiple of the tile, so the last tile straddles
    the end of every row; columns q < band and cells with q + d > N in
    every row; the 40-nt row shorter than the band."""
    dt = ab._DTYPES[dtype]
    t, s, lens, n_max, g, ins = _batch(dt, band)
    assert (n_max + 1) % tile != 0 and int(lens.min()) < band
    geometry = {"threads": threads, "tile": tile}
    _assert_planes(_emu(emu_lib, "inside", dt, s, lens, n_max, band,
                        **geometry), g, dt)
    args = _outside_args(lens, ins)
    og = ab.make_outside_grids(t, s, lens, n_max, band, dt, g, *args)
    _assert_planes(_emu(emu_lib, "outside", dt, s, lens, n_max, band,
                        (g, *args[1:], args[0]), **geometry), og, dt)
