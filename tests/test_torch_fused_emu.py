"""The fused stage's CUDA source (csrc/fused_expand.cu: the expansion and
the threshold, each one launch whose compaction is a single pass with a
decoupled look-back, and the records' copy to the host), compiled by g++
against a CPU stand-in for the CUDA built-ins (tests/cuda_emu/
cuda_runtime.h: one std::thread per CUDA thread), against its plain
PyTorch versions, search/fused.py:_expand_core and _thresh_core, on the
tiny goldens' wave (tests/test_torch_fused.py's set-up) and on waves made
from it:

- the expanded hits equal native stage 1 (ops/native/search.cc) and
  _expand_core bit for bit: every int64 column exact, acc_e and hyb_e
  compared as uint64 bits;
- the threshold's records, copied to the host and unpacked, equal
  _thresh_core's dict exactly: every field in dtype and bits.

Every kernel case runs in both of the emulator's launch modes: the CTAs
one after another, and all of a grid's CTAs at once as threads, so that a
tile's look-back waits on tiles of other CTAs. Cases: blocks that start
inside a candidate (o > 0); blocks of 1, 31 and 33 pairs and the rest of
the wave in tiles of 32 and 64 threads over grids of 1 and 3 CTAs (a CTA
takes several tiles, holding each over the next one's compute), of a CTA
per tile and of the default (as many as the card holds: 3 here); a block with no survivors and
one where every pair survives; one candidate over many tiles; tiles over
many candidates of one pair each, and over candidates of no pair between
them (longer than a tile's staged slice of the prefix); an empty wave.
The records' copy in runs (as the pinned ring copies them); the host
arrays that a wave's blocks fill. The fused stage through the emulated
kernels equals the staged stream and the JAX package's fused stage. The
wrappers' input checks raise before either path runs.

This runs the kernels' own arithmetic, indexing, ballots, barriers and
look-back on a machine without a card; the card's comparison is
tests/test_torch_gpu.py and chip_smoke.py [fused].
"""

import copy
import ctypes

import numpy as np
import pytest
import torch

from priblast_tpu.search import fused as jfused
from priblast_tpu.search import pipeline as jpl
from priblast_tpu_torch.ops import fused_expand as fe
from priblast_tpu_torch.ops import ungapped_extend as uop
from priblast_tpu_torch.search import fused
from priblast_tpu_torch.search import pipeline as tpl
from test_torch_fused import staged  # noqa: F401 (a fixture)
from test_torch_kernel_emu import _emu_build
from test_torch_ungapped import stream_of

# one intra-op thread: PyTorch's idle workers would compete with the
# emulated CUDA threads for the host's cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
EMU_THREADS = 64


@pytest.fixture(scope="module")
def emu_build(tmp_path_factory):
    lib = fe.bind(_emu_build(tmp_path_factory.mktemp("fused_emu"), fe.SRC,
                             ()))
    lib.emu_concurrent_blocks.argtypes = [ctypes.c_int]
    return lib


@pytest.fixture(params=["serial", "concurrent"])
def emu_lib(emu_build, request):
    """The emulated source, its CTAs run one after another or all at
    once."""
    emu_build.emu_concurrent_blocks(int(request.param == "concurrent"))
    yield emu_build
    emu_build.emu_concurrent_blocks(0)


def _wave(staged, hyb_e=None):
    """The tiny wave's candidates (hybrid energies set to `hyb_e` where
    given) and their wave buffers on the CPU."""
    _chunks, p, _queries, qpack, dbpack, _pres, _posts, cands = staged
    if hyb_e is not None:
        cands = [(g, {**c, "hyb_e": np.full_like(c["hyb_e"], hyb_e)})
                 for g, c in cands]
    return p, cands, fused._WaveBuffers(cands, qpack, dbpack, CPU), qpack, \
        dbpack


def _synthetic(staged, case: str):
    """A wave made from the tiny wave's packs: `long`, one candidate of 10
    query x 30 db positions (300 pairs: many tiles); `ones`, the tiny
    wave's candidates of one pair each (a tile over as many candidates);
    `gaps`, those with 40 candidates of no pair before each (a tile's
    slice of the prefix longer than the tile)."""
    p, cands, _wb, qpack, dbpack = _wave(staged)
    if case == "long":
        one = np.ones(1, np.int64)
        cands = [((0, 0), {"q_sp": 0 * one, "db_sp": 9 * one,
                           "q_len": 0 * one, "db_len": 29 * one,
                           "dbseq_id": 6 * one, "hyb_e": -2.5 * one})]
    else:
        out = []
        for g, c in cands:
            single = ((c["db_sp"] == c["q_sp"])
                      & (c["db_len"] == c["q_len"]))
            c = {k: c[k][single] for k in ("q_sp", "db_sp", "q_len",
                                              "db_len", "dbseq_id", "hyb_e")}
            if case == "gaps":  # q interval [lo, lo - 1]: no pair
                c = {k: np.repeat(v, 41) for k, v in c.items()}
                c["db_sp"] = c["db_sp"] - (np.arange(len(c["q_sp"])) % 41
                                           != 40)
            if len(c["q_sp"]):
                out.append((g, c))
        cands = out
    return p, cands, fused._WaveBuffers(cands, qpack, dbpack, CPU), qpack, \
        dbpack


def _inside(wb) -> int:
    """A pair one past the start of the first candidate of 3 or more
    pairs: a block from there starts inside that candidate."""
    ci = int(torch.nonzero(torch.diff(wb.cum) >= 3)[0])
    return int(wb.cum[ci]) + 1


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _assert_same_hits(got: dict, ref: dict):
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert torch.equal(_bits(got[k]), _bits(ref[k])), k


def _grid(grid, n: int, threads: int) -> int:
    """CTAs of a launch: `grid`, or one per tile of n items for "tiles"
    (0: as many as the card holds, 3 in the emulator)."""
    return max(1, -(-n // threads)) if grid == "tiles" else grid


def _expand(lib, p, wb, qpack, dbpack, o, B, grid=3, threads=EMU_THREADS):
    return fe.expand_call(lib, p.min_accessible_length, p.max_seed_length, o,
                          B, wb, qpack, dbpack, 0, threads=threads,
                          grid=_grid(grid, B, threads))


def _plain_expand(p, wb, qpack, dbpack, o, B):
    return fused._expand_core(p.min_accessible_length, p.max_seed_length, o,
                              B, wb, qpack, dbpack)


def _extend(p, hits, qpack, dbpack):
    return uop.ungapped_extend(
        hits["q_sp"], hits["db_sp"], hits["length"], hits["dbseq_start"],
        hits["acc_e"].float(), hits["hyb_e"].float(), hits["qb"],
        hits["qab"], hits["dbb"], hits["aoff"], hits["coff"], qpack.bufs,
        dbpack.bufs, p.min_accessible_length, p.drop_out_length_wo_gap)


def _assert_same_records(got: dict, ref: dict):
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert np.array_equal(got[k].view(np.uint8), ref[k].view(np.uint8)), k


def test_expansion_source_matches_native_stage1(emu_lib, staged):
    """The whole wave in one block, 3 CTAs of 64 threads: the survivors
    equal native stage 1 (groups, positions, ids, the flat-buffer bases;
    acc_e and hyb_e as uint64 bits) and _expand_core's columns."""
    p, _cands, wb, qpack, dbpack = _wave(staged)
    pres = staged[5]
    got = _expand(emu_lib, p, wb, qpack, dbpack, 0, wb.tot)
    _assert_same_hits(got, _plain_expand(p, wb, qpack, dbpack, 0, wb.tot))
    hits = {k: v.numpy() for k, v in got.items()}
    ref = stream_of(pres, qpack, dbpack)
    assert len(ref) > 0 and len(hits["pid"]) == len(ref)
    for (_q, _c, plo, phi), (_q2, _c2, lo, hi) in zip(wb.gbounds,
                                                       ref.groups):
        assert np.searchsorted(hits["pid"], plo) == lo
        assert np.searchsorted(hits["pid"], phi) == hi
    for k in ("q_sp", "db_sp", "dbseq_id", "dbseq_start", "qb", "qab", "dbb",
              "aoff", "coff"):
        assert np.array_equal(hits[k], ref.soa[k]), k
    assert np.array_equal(hits["length"], ref.soa["q_len"])
    for k in ("acc_e", "hyb_e"):
        assert np.array_equal(hits[k].view(np.uint64),
                              ref.soa[k].view(np.uint64)), k


@pytest.mark.parametrize("B", [1, 31, 33, "rest"])
@pytest.mark.parametrize("grid", [1, 3, "tiles"])
@pytest.mark.parametrize("threads", [32, 64])
def test_expansion_source_blocks_match_plain_version(emu_lib, staged, B,
                                                     grid, threads):
    """Blocks that start one pair inside a candidate of several pairs, of
    1, 31, 33 pairs and the rest of the wave, in tiles of 32 or 64 threads
    on 1 or 3 CTAs (each takes several tiles in turn) or one per tile:
    _expand_core's columns bit for bit."""
    p, _cands, wb, qpack, dbpack = _wave(staged)
    o = _inside(wb)
    n = wb.tot - o if B == "rest" else B
    assert n > 0 and o + n <= wb.tot
    got = _expand(emu_lib, p, wb, qpack, dbpack, o, n, grid=grid,
                  threads=threads)
    ref = _plain_expand(p, wb, qpack, dbpack, o, n)
    assert len(ref["pid"]) > 0
    _assert_same_hits(got, ref)


@pytest.mark.parametrize("case", ["long", "ones", "gaps"])
@pytest.mark.parametrize("threads,grid", [(32, 3), (64, 0), (64, "tiles")])
def test_expansion_and_threshold_sources_on_made_waves(emu_lib, staged,
                                                       case, threads, grid):
    """One candidate over many tiles (and a block from inside it), tiles
    over many candidates of one pair each, and over candidates of no pair
    between them: _expand_core's columns bit for bit, and the threshold's
    records _thresh_core's."""
    p, _cands, wb, qpack, dbpack = _synthetic(staged, case)
    counts = torch.diff(wb.cum)
    if case == "long":
        assert wb.tot == 300 and len(counts) == 1
    else:
        assert counts.max() == 1 and wb.tot > 4 * threads
        assert (case == "gaps") == bool((counts == 0).any())
    for o in (0, 37):
        got = _expand(emu_lib, p, wb, qpack, dbpack, o, wb.tot - o,
                      grid=grid, threads=threads)
        ref = _plain_expand(p, wb, qpack, dbpack, o, wb.tot - o)
        assert 0 < len(ref["pid"])
        _assert_same_hits(got, ref)
    res = _extend(p, got, qpack, dbpack)
    _assert_same_records(
        fe.threshold_call(emu_lib, p.interaction_energy_threshold, res, got,
                          0, threads=threads,
                          grid=_grid(grid, len(got["pid"]), threads)),
        fused._thresh_core(p, res, got))


@pytest.mark.parametrize("hyb_e,kept", [(1e3, "none"), (-1e3, "all")])
def test_expansion_source_with_no_survivor_or_every_pair(emu_lib, staged,
                                                        hyb_e, kept):
    """Every candidate's hybrid energy moved so that no pair passes the
    filter, or every pair does: _expand_core's (empty or full) columns."""
    p, _cands, wb, qpack, dbpack = _wave(staged, hyb_e)
    got = _expand(emu_lib, p, wb, qpack, dbpack, 0, wb.tot)
    ref = _plain_expand(p, wb, qpack, dbpack, 0, wb.tot)
    assert len(ref["pid"]) == (0 if kept == "none" else wb.tot)
    _assert_same_hits(got, ref)
    res = _extend(p, got, qpack, dbpack)
    _assert_same_records(
        fe.threshold_call(emu_lib, p.interaction_energy_threshold, res, got,
                          0, threads=EMU_THREADS, grid=3),
        fused._thresh_core(p, res, got))


def test_expansion_and_threshold_sources_on_an_empty_wave(emu_lib, staged):
    """A wave of no candidates: an empty block launches nothing and gives
    _expand_core's empty columns; the threshold of no hits gives
    _thresh_core's empty records."""
    p, _cands, _wb, qpack, dbpack = _wave(staged)
    wb = fused._WaveBuffers([], qpack, dbpack, CPU)
    assert wb.tot == 0
    got = _expand(emu_lib, p, wb, qpack, dbpack, 0, 0)
    ref = _plain_expand(p, wb, qpack, dbpack, 0, 0)
    _assert_same_hits(got, ref)
    res = _extend(p, got, qpack, dbpack)
    _assert_same_records(
        fe.threshold_call(emu_lib, p.interaction_energy_threshold, res, got,
                          0, threads=EMU_THREADS),
        fused._thresh_core(p, res, got))


@pytest.mark.parametrize("threads,grid", [(64, 3), (32, 1), (64, 0),
                                          (32, "tiles")])
def test_threshold_source_matches_plain_version(emu_lib, staged, threads,
                                                grid):
    """The threshold on the ungapped output of the whole wave and of a
    block that starts inside a candidate: _thresh_core's records, every
    field in dtype and bits."""
    p, _cands, wb, qpack, dbpack = _wave(staged)
    for lo, n in ((0, wb.tot), (_inside(wb), 33)):
        hits = _expand(emu_lib, p, wb, qpack, dbpack, lo, n)
        res = _extend(p, hits, qpack, dbpack)
        got = fe.threshold_call(emu_lib, p.interaction_energy_threshold, res,
                                hits, 0, threads=threads,
                                grid=_grid(grid, len(hits["pid"]), threads))
        ref = fused._thresh_core(p, res, hits)
        assert 0 < len(ref["pid"]) < len(hits["pid"])
        _assert_same_records(got, ref)


@pytest.mark.parametrize("thr", [-1e9, 1e9])
def test_threshold_source_keeps_no_hit_or_every_hit(emu_lib, staged, thr):
    """A threshold below every energy keeps no hit; one above keeps all."""
    p, _cands, wb, qpack, dbpack = _wave(staged)
    hits = _expand(emu_lib, p, wb, qpack, dbpack, 0, wb.tot)
    res = _extend(p, hits, qpack, dbpack)
    got = fe.threshold_call(emu_lib, thr, res, hits, 0,
                            threads=EMU_THREADS, grid=3)

    class _P:
        interaction_energy_threshold = thr

    ref = fused._thresh_core(_P, res, hits)
    assert len(ref["pid"]) == (0 if thr < 0 else len(hits["pid"]))
    _assert_same_records(got, ref)


@pytest.fixture
def emulated_stage(emu_lib, monkeypatch):
    """fused_stage with the wrappers' CPU path replaced by the emulated
    kernels (blocks of 100 pairs, 2 CTAs of 64 threads)."""
    def expand_start(d, max_len, o, B, wb, qpack, dbpack):
        return fe.expand_launch(emu_lib, d, max_len, o, B, wb, qpack, dbpack,
                                0, threads=EMU_THREADS, grid=2)

    def threshold_start(p, res, hits):
        rec = fe.threshold_call(emu_lib, p.interaction_energy_threshold, res,
                                hits, 0, threads=EMU_THREADS, grid=2)
        return fe.PendingRecords(len(rec["pid"]), plain=rec)

    monkeypatch.setattr(fe, "expand_start", expand_start)
    monkeypatch.setattr(fe, "threshold_start", threshold_start)

    def run(p, cands, qpack, dbpack):
        return fused.fused_stage(p, cands, qpack, dbpack, devices=CPU,
                                 block=100)

    return run


def test_fused_stage_through_the_source_equals_staged_and_jax(staged,
                                                              emulated_stage):
    """The fused stage in blocks of 100 pairs through the emulated kernels:
    the staged stream (native stage 1 -> ungapped_stage ->
    threshold_stage), every field identical in value and dtype; and the JAX
    package's fused stage in float64 on the same candidates, groups and
    integer fields exact, energies within 1e-5 kcal/mol (the bound of
    tests/test_torch_fused.py: XLA's CPU backend fuses each loop energy's
    x / 100 as x * 0.01 into the next add)."""
    chunks, p, queries, qpack, dbpack, pres, _posts, cands = staged
    got = emulated_stage(p, cands, qpack, dbpack)
    ref = stream_of(pres, qpack, dbpack)
    tpl.ungapped_stage(ref, qpack, dbpack, p, device=CPU)
    ref = tpl.threshold_stage(ref, p)
    assert len(got) > 0 and got.groups == ref.groups
    for k in tpl.STREAM_KEYS:
        assert got.soa[k].dtype == ref.soa[k].dtype, k
        assert np.array_equal(got.soa[k], ref.soa[k]), k
    jq = jpl.QueryPack([q[0].astype(np.int32) for q in queries],
                       [q[2] for q in queries], [q[3] for q in queries],
                       [q[1] for q in queries])
    jref = jfused.fused_stage(p, cands, jq, jpl.DbPack(chunks),
                              dtype="float64")
    assert got.groups == jref.groups
    for k in ("q_sp", "db_sp", "q_len", "db_len", "dbseq_start",
              "dbseq_id"):
        assert np.array_equal(got.soa[k], np.asarray(jref.soa[k])), k
    for k in uop.FLOAT_KEYS:
        np.testing.assert_allclose(got.soa[k], np.asarray(jref.soa[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def _refuse(*_a, **_k):
    raise AssertionError("the plain version ran on inputs the wrapper "
                         "should have refused")


@pytest.mark.parametrize("bad", ["block", "range", "offset", "cum", "cand",
                                 "energy", "q_acc", "db_sa", "pos_ls",
                                 "device"])
def test_expand_wrapper_rejects_bad_inputs(staged, monkeypatch, bad):
    """expand raises ValueError before it dispatches (the plain version is
    never called) on a block past MAX_BLOCK or past the wave, a negative
    offset, a tensor of the wrong dtype, shape or device; on good CPU
    inputs it returns _expand_core's columns."""
    p, _cands, wb, qpack, dbpack = _wave(staged)
    # shallow copies: the cases replace their tensors
    qpack, dbpack = copy.copy(qpack), copy.copy(dbpack)
    d, ml = p.min_accessible_length, p.max_seed_length
    _assert_same_hits(fe.expand(d, ml, 3, 40, wb, qpack, dbpack),
                      _plain_expand(p, wb, qpack, dbpack, 3, 40))
    o, B = 3, 40
    if bad == "block":
        B, wb.tot = fe.MAX_BLOCK + 1, fe.MAX_BLOCK + 10
    elif bad == "range":
        o = wb.tot - 5
    elif bad == "offset":
        o = -1
    elif bad == "cum":
        wb.cum = wb.cum.int()
    elif bad == "cand":
        wb.cand = wb.cand[:6].contiguous()
    elif bad == "energy":
        wb.energy = wb.energy.float()
    elif bad == "q_acc":
        qpack.bufs = (qpack.bufs[0], qpack.bufs[1].double(), qpack.bufs[2])
    elif bad == "db_sa":
        dbpack.sa = dbpack.sa[::2]
    elif bad == "pos_ls":
        dbpack.pos_ls = dbpack.pos_ls[:-1]
    else:
        dbpack.pos_sid = dbpack.pos_sid.to("meta")
    monkeypatch.setattr(fused, "_expand_core", _refuse)
    with pytest.raises(ValueError):
        fe.expand(d, ml, o, B, wb, qpack, dbpack)


@pytest.mark.parametrize("bad", ["int_dtype", "float_dtype", "shape",
                                 "contiguous", "pid", "device"])
def test_threshold_wrapper_rejects_bad_inputs(staged, monkeypatch, bad):
    """threshold raises ValueError before it dispatches on an ungapped
    output or hit column of the wrong dtype, shape, layout or device; on
    good CPU inputs it returns _thresh_core's records."""
    p, _cands, wb, qpack, dbpack = _wave(staged)
    hits = _plain_expand(p, wb, qpack, dbpack, 0, 64)
    res = _extend(p, hits, qpack, dbpack)
    _assert_same_records(fe.threshold(p, res, hits),
                         fused._thresh_core(p, res, hits))
    res, hits = dict(res), dict(hits)
    if bad == "int_dtype":
        res["db_sp"] = res["db_sp"].int()
    elif bad == "float_dtype":
        res["energy"] = res["energy"].double()
    elif bad == "shape":
        res["acc_e"] = res["acc_e"][:-1]
    elif bad == "contiguous":
        res["q_len"] = torch.stack([res["q_len"]] * 2, 1)[:, 0]
    elif bad == "pid":
        hits["pid"] = hits["pid"][1:]
    else:
        hits["dbseq_id"] = hits["dbseq_id"].to("meta")
    monkeypatch.setattr(fused, "_thresh_core", _refuse)
    with pytest.raises(ValueError):
        fe.threshold(p, res, hits)


def test_packed_records_unpack_to_the_stream_dtypes():
    """unpack reads RECORD_BYTES per hit: pid int64 first, then the int32
    and float32 fields, each a contiguous view of the buffer."""
    n = 3
    buf = np.zeros(fe.RECORD_BYTES * n, np.uint8)
    buf[: 8 * n].view(np.int64)[:] = [7, 8, 1 << 40]
    ints = buf[8 * n: 8 * n + 4 * 6 * n].view(np.int32).reshape(6, n)
    ints[:] = np.arange(18).reshape(6, n)
    buf[32 * n:].view(np.float32)[:] = np.arange(9, dtype=np.float32) / 4
    out = fe.unpack(buf, n)
    assert list(out) == [*uop.INT_KEYS, *uop.FLOAT_KEYS, "dbseq_id", "pid"]
    assert out["pid"].tolist() == [7, 8, 1 << 40]
    assert out["dbseq_id"].tolist() == [15, 16, 17]
    assert out["q_sp"].tolist() == [0, 1, 2]
    assert out["energy"].tolist() == [1.5, 1.75, 2.0]
    assert all(v.dtype == (np.int64 if k == "pid" else np.float32
                           if k in uop.FLOAT_KEYS else np.int32)
               for k, v in out.items())


def test_records_copy_in_runs_equals_one_copy(emu_build, staged):
    """The C entry point's copy of records r0 .. r0 + m - 1 into a buffer
    laid out for m (the pinned ring's chunks), run after run, put into
    HostRecords packed (as the ring does) or unpacked, gives the records of
    one copy of all; a run past the records is refused."""
    p, _cands, wb, qpack, dbpack = _wave(staged)
    hits = _expand(emu_build, p, wb, qpack, dbpack, 0, wb.tot)
    res = _extend(p, hits, qpack, dbpack)
    records, scratch = fe.threshold_launch(
        emu_build, p.interaction_energy_threshold, res, hits, 0,
        threads=EMU_THREADS, grid=3)
    n, n2 = len(hits["pid"]), int(scratch[1])
    whole = fe.threshold_call(emu_build, p.interaction_energy_threshold, res,
                              hits, 0, threads=EMU_THREADS, grid=3)
    assert n2 == len(whole["pid"]) > 20
    sink = fe.HostRecords(n2 + 5)
    for r0 in range(0, n2, 7):
        m = min(7, n2 - r0)
        buf = np.empty(fe.RECORD_BYTES * m, np.uint8)
        fe._call(emu_build.fused_records_to_host, "copy",
                 (records.data_ptr(), buf.ctypes.data), (r0, m, n, m))
        if r0 % 2:
            sink.put(fe.unpack(buf, m), r0)
        else:
            sink.put_packed(buf, m, r0)
    _assert_same_records(sink.columns(n2), whole)
    with pytest.raises(RuntimeError):
        fe._call(emu_build.fused_records_to_host, "copy",
                 (records.data_ptr(), buf.ctypes.data), (n - 1, 2, n, 2))


def test_host_records_fill_in_order_and_give_contiguous_columns():
    """HostRecords: parts put at their rows give _thresh_core's keys and
    dtypes, each column a contiguous view of n records."""
    def part(lo, m):
        rec = {k: np.arange(lo, lo + m, dtype=np.int32)
               for k in (*uop.INT_KEYS, *uop.FLOAT_KEYS, "dbseq_id")}
        rec.update((k, rec[k].astype(np.float32)) for k in uop.FLOAT_KEYS)
        rec["pid"] = np.arange(lo, lo + m, dtype=np.int64) << 33
        return rec

    sink = fe.HostRecords(100)
    sink.put(part(0, 3), 0)
    sink.put(part(3, 4), 3)
    out = sink.columns(7)
    assert list(out) == [*uop.INT_KEYS, *uop.FLOAT_KEYS, "dbseq_id", "pid"]
    for k, v in out.items():
        assert v.flags.c_contiguous and len(v) == 7, k
        assert v.dtype == (np.int64 if k == "pid" else np.float32
                           if k in uop.FLOAT_KEYS else np.int32), k
        assert v.tolist() == (np.arange(7) << 33 if k == "pid"
                              else np.arange(7)).tolist(), k
