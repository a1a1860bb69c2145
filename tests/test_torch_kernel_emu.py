"""The CUDA kernels' sources, compiled by g++ against a CPU stand-in for
the CUDA built-ins (tests/cuda_emu/cuda_runtime.h: one std::thread per
CUDA thread), against their plain PyTorch versions on the tiny goldens:
the gapped kernel (one warp per block) on the mid-stage hits, integers,
traceback lists and floats identical, also on synthetic GC-rich hits
(every band cell admitted, diagonals of hundreds of combos, equal energies
whose order decides, overflow at max_ext), with its -DGAPPED_STAMPS
build's counts against the plain version's, and its refusal of max_ext
past 32; the ungapped kernel (a thread per
hit) on the stage-1 hits, on exact argmin ties, on a batch that mixes
long and short hits in every warp, on batches smaller than a warp or
ending inside a warp and on hits that step past both ends of the flat
buffers, integers and float32 energies identical.

This runs the kernel's own arithmetic, indexing and warp-level protocol on
a machine without a card; it does not replace the comparison on the card
(tests/test_torch_gpu.py, chip_smoke.py), where nvcc and the hardware's
warps run it.
"""

import ctypes
import inspect
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
import ungapped_cases as uc

from priblast_tpu_torch.models import db as tdb
from priblast_tpu_torch.ops import gapped_sweep as sweep_op
from priblast_tpu_torch.ops import native
from priblast_tpu_torch.ops import ungapped_extend as ungapped_op
from priblast_tpu_torch.search import pipeline as tpl
from priblast_tpu_torch.utils import alphabet, fasta, store
from priblast_tpu_torch.utils.params import DbParams, RisParams

TESTS = Path(__file__).resolve().parent
N_HITS = 32


def _emulated_source(src: str) -> str:
    """The kernel source with its launch turned into emu_launch and its
    dynamic shared memory declarations into pointers to the block's own."""
    out, n = re.subn(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+), [^>]+>>>\((\w+)\);",
                     r"emu_launch(\1, \2, \3, \4, \5);", src)
    assert n == 1, "the kernel launch was not found"
    out, n = re.subn(r"extern __shared__ __align__\(16\) unsigned char "
                     r"smem\[\];", "unsigned char *const smem = emu_smem();",
                     out)
    assert n >= 1, "no dynamic shared memory declaration was found"
    return out


def _emu_build(d: Path, src: Path, entry_points, flags=(),
               text: str | None = None) -> ctypes.CDLL:
    """g++ build of a kernel source (or of `text` in its place) against
    tests/cuda_emu/, with extra `flags`; the C entry points take (ptrs,
    sizes, iparams, stream) and return an int."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed (it also builds the native engine)"
    emu = d / f"{src.stem}_emu.cc"
    emu.write_text(_emulated_source(src.read_text() if text is None
                                    else text))
    lib = d / f"lib{src.stem}_emu.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", str(TESTS / "cuda_emu"), *flags, "-o",
                    str(lib), str(emu), "-lpthread"], check=True)
    out = ctypes.CDLL(str(lib))
    for name in entry_points:
        getattr(out, name).restype = ctypes.c_int
        getattr(out, name).argtypes = [ctypes.c_void_p] * 4
    return out


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    return _emu_build(tmp_path_factory.mktemp("kernel_emu"), sweep_op._SRC,
                      ("gapped_extend_f32", "gapped_extend_f64"))


@pytest.fixture(scope="module")
def tiny_hits(tmp_path_factory):
    """Mid-stage hits of the tiny goldens (native stage 2 + chain_mid) and
    the flat CPU buffers they index."""
    data = TESTS / "data"
    db_name = str(tmp_path_factory.mktemp("kernel_emu_db") / "tiny_db")
    tdb.run(DbParams(input=str(data / "tiny_db.fa"), db_name=db_name,
                     engine="exact"))
    chunks = store.load_chunks(db_name, 8)
    p = RisParams(input="x", output="y", db_name=db_name, engine="exact")
    p.load_db_params()
    _names, seqs = fasta.read_fasta(data / "tiny_q.fa")
    queries, pres, mids = [], [], []
    for seq in seqs:
        q_acc, q_cond = native.raccess(alphabet.access_codes(seq), 70, 5)
        q_enc = alphabet.encode_query(seq, p.repeat_flag)
        q_sa = native.sa_build(q_enc)
        queries.append((q_enc, q_acc, q_cond, q_sa))
        pres.append(native.search_chunk(q_enc, q_sa, q_acc, q_cond,
                                        chunks[0], p, stage=1))
        post = native.search_chunk(q_enc, q_sa, q_acc, q_cond, chunks[0], p,
                                   stage=2)
        mids.append(native.chain_mid(q_enc, chunks[0], p, post))
    cpu = torch.device("cpu")
    qpack = tpl.QueryPack(*zip(*queries), devices=cpu)
    dbpack = tpl.DbPack(chunks, devices=cpu)
    stream = tpl._concat_groups(mids, [(q, 0) for q in range(len(mids))])
    tpl._hit_bases(stream, qpack, dbpack)
    soa = {k: torch.as_tensor(v[:N_HITS]).long()
           for k, v in stream.soa.items()}
    energy = torch.as_tensor(stream.soa["energy"][:N_HITS]).double()
    acc = torch.as_tensor(stream.soa["acc_e"][:N_HITS]).double()
    stage1 = tpl._concat_groups(pres, [(q, 0) for q in range(len(pres))])
    tpl._hit_bases(stage1, qpack, dbpack)
    return soa, energy, acc, qpack.bufs, dbpack.bufs, stage1.soa


@pytest.mark.parametrize("dtype,max_ext,dropout,min_helix", [
    ("float32", 32, 16, 3),
    ("float64", 32, 16, 3),
    ("float32", 16, 9, 2),
    ("float64", 24, 9, 2),
])
def test_kernel_source_matches_plain_version_in_emulation(
        emu_lib, tiny_hits, dtype, max_ext, dropout, min_helix):
    soa, energy, acc, qbufs, dbufs, _stage1 = tiny_hits
    kw = dict(d=5, dropout=dropout, min_helix=min_helix, max_ext=max_ext,
              dtype=dtype)
    fn = (emu_lib.gapped_extend_f32 if dtype == "float32"
          else emu_lib.gapped_extend_f64)
    valid = torch.ones(N_HITS, dtype=torch.bool)
    valid[3] = False
    bases = tuple(soa[k] for k in ("qb", "qab", "dbb", "aoff", "coff"))
    bufs = (qbufs[0], dbufs[0], qbufs[1], qbufs[2], dbufs[1], dbufs[2])
    starts = {0: (soa["q_sp"], soa["db_sp"],
                  soa["dbseq_start"] + soa["db_len"] - 1),
              1: (soa["q_sp"] + soa["q_len"] - 1,
                  soa["db_sp"] + soa["db_len"] - 1, soa["dbseq_start"])}
    swept = 0
    for flag, (q0, d0, anchor) in starts.items():
        args = (q0, d0, anchor, energy, acc, valid, *bases, *bufs)
        plain = sweep_op.gapped_extend_dir(*args, flag=flag, **kw)
        emu = sweep_op._call(fn, args, 0, flag=flag, **kw)
        for name, a, b in zip(("ints", "floats", "tb"), emu, plain):
            assert torch.equal(a, b), (flag, name)
        swept += int(plain[0][:, 4].sum())
        assert (plain[0][3] == 0).all() and (plain[2][3] == 0).all()
    assert swept > 10 * N_HITS   # the hits do extend


@pytest.mark.parametrize("max_ext", [33, 64, 120])
def test_kernel_source_refuses_max_ext_past_a_warp_in_emulation(
        emu_lib, tiny_hits, max_ext):
    """The C entry points return cudaErrorInvalidValue for max_ext past
    KERNEL_MAX_EXT (the source's kWorkMax), in either dtype, and write
    none of their outputs; the plain version still runs them."""
    soa, energy, acc, qbufs, dbufs, _stage1 = tiny_hits
    src = sweep_op._SRC.read_text()
    assert f"constexpr int kWorkMax = {sweep_op.KERNEL_MAX_EXT};" in src
    assert max_ext > sweep_op.KERNEL_MAX_EXT
    valid = torch.ones(N_HITS, dtype=torch.bool)
    args = (soa["q_sp"], soa["db_sp"], soa["dbseq_start"], energy, acc,
            valid, *(soa[k] for k in ("qb", "qab", "dbb", "aoff", "coff")),
            qbufs[0], dbufs[0], qbufs[1], qbufs[2], dbufs[1], dbufs[2])
    kw = dict(flag=1, d=5, dropout=16, min_helix=3, max_ext=max_ext)
    for dtype, fn in (("float32", emu_lib.gapped_extend_f32),
                      ("float64", emu_lib.gapped_extend_f64)):
        after = []

        def marked(ptrs, sizes, iparams, stream, _fn=fn, _dt=dtype):
            # the outputs (ptrs 19-21: ints, floats, tb) marked before the
            # call and read back after it
            B, steps = sizes[6], iparams[6]
            item = 4 if _dt == "float32" else 8
            outs = ((ptrs[19], B * 5 * 4), (ptrs[20], B * 2 * item),
                    (ptrs[21], B * 2 * steps * 4))
            for at, n in outs:
                ctypes.memset(at, 0x5A, n)
            err = _fn(ptrs, sizes, iparams, stream)
            after.extend(ctypes.string_at(at, n) == b"\x5a" * n
                         for at, n in outs)
            return err

        with pytest.raises(RuntimeError, match="CUDA error 1$"):
            sweep_op._call(marked, args, 0, dtype=dtype, **kw)
        assert after == [True] * 3
        ints, _floats, _tb = sweep_op.extend_dir_plain(*args, dtype=dtype,
                                                       **kw)
        assert int(ints[:, 4].max()) > 0


# ---- the work list on synthetic GC-rich hits -------------------------------

STAMP_KEYS = ("hits", "diagonals", "band", "admitted", "combos", "steps",
              "empty", "busiest", "rounds", "nopred")  # kernel's kS* order
N_STAMPS = len(STAMP_KEYS) + 7                          # then 7 cycle sums
GAPPED_KW = dict(d=5, dropout=16, min_helix=3, max_ext=32)

# query, db: every band cell admitted (G pairs with C everywhere); a
# periodic pair where some cells pair and some do not; and one whose
# tracebacks pass equal-energy combos that meet in one round's lanes and in
# different rounds
SYNTHETIC = {"every_cell_admitted": ("G" * 120, "C" * 120),
             "periodic": ("GGCGCC" * 20, "GGCGCC" * 20),
             "tied": ("GGGAGG" * 20, "CCUCCC" * 20)}


def _synthetic_args(name: str, n_hits: int = 2):
    """gapped_extend_dir's arguments for `n_hits` hits spread over a
    synthetic query and db (SYNTHETIC[name]), with accessibility energies in
    [0, 0.3) from a fixed seed."""
    q, d = SYNTHETIC[name]
    code = {"A": 2, "C": 3, "G": 4, "U": 5}
    q_enc = torch.tensor([code[c] for c in q], dtype=torch.int64)
    db_seq = torch.tensor([code[c] for c in d], dtype=torch.int64)
    g = torch.Generator().manual_seed(7)

    def acc(n):
        return (torch.rand(n + 8, generator=g) * 0.3).float()

    q_acc, q_cond, db_acc, db_cond = (acc(len(q)), acc(len(q)), acc(len(d)),
                                      acc(len(d)))
    q_start = torch.linspace(len(q) // 3, 2 * len(q) // 3, n_hits).long()
    db_start = torch.linspace(len(d) // 3, 2 * len(d) // 3, n_hits).long()
    zero = torch.zeros(n_hits, dtype=torch.int64)
    return (q_start, db_start, db_start.clone(),
            torch.full((n_hits,), -8.0, dtype=torch.float64),
            torch.full((n_hits,), 1.0, dtype=torch.float64),
            torch.ones(n_hits, dtype=torch.bool), zero, zero, zero, zero,
            zero, q_enc, db_seq, q_acc, q_cond, db_acc, db_cond)


def _emu_equals_plain_gapped(lib, args, dtype, **kw):
    """Both flags: the emulated kernel's integers, floats and traceback
    lists equal the plain version's; returns the plain version's work
    counts (summed over both flags) and the overflow flags."""
    fn = (lib.gapped_extend_f32 if dtype == "float32"
          else lib.gapped_extend_f64)
    counts, ovf = {}, []
    for flag in (0, 1):
        k = dict(GAPPED_KW, **kw, flag=flag, dtype=dtype)
        plain = sweep_op.extend_dir_plain(*args, **k, counts=counts)
        emu = sweep_op._call(fn, args, 0, **k)
        for name, a, b in zip(("ints", "floats", "tb"), emu, plain):
            assert torch.equal(a, b), (flag, name)
        ovf.append(plain[0][:, 3])
    return counts, torch.cat(ovf)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["every_cell_admitted", "periodic"])
def test_work_list_on_gc_rich_hits_in_emulation(emu_lib, name, dtype):
    """Diagonals of more combos than the 32-entry list holds, so the list
    fills and runs several rounds: every band cell admitted (G against C),
    and a periodic pair where a round holds several cells' runs; the hits
    run to max_ext 32 and overflow. Bit for bit with the plain version."""
    counts, ovf = _emu_equals_plain_gapped(emu_lib, _synthetic_args(name),
                                           dtype)
    assert counts["combos"] > 32 * counts["diagonals"]   # several rounds
    assert counts["rounds"] > 2 * counts["diagonals"]
    assert bool(ovf.all())                                # past max_ext 32
    if name == "every_cell_admitted":
        assert counts["admitted"] == counts["band"] > 0
    else:
        assert 0 < counts["admitted"] < counts["band"]


# the tie rule at the two places where the work list meets equal energies,
# each turned round in a variant of the source: in one round's lanes (the
# segmented minimum) and across rounds (the cell lane's merge)
TIE_RULES = {"lanes": "(ov == v && oq < qc)",
             "rounds": "(hv == run_min && hq < run_q)"}


@pytest.fixture(scope="module")
def late_libs(tmp_path_factory):
    """Builds of the source in which the later of two equal combos wins,
    at each place of TIE_RULES."""
    src = sweep_op._SRC.read_text()
    libs = {}
    for at, old in TIE_RULES.items():
        assert src.count(old) == 1
        libs[at] = _emu_build(tmp_path_factory.mktemp(f"late_{at}"),
                              sweep_op._SRC,
                              ("gapped_extend_f32", "gapped_extend_f64"),
                              text=src.replace(old, old.replace(" < ", " > ")))
    return libs


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_work_list_keeps_the_first_minimum_across_lanes_and_rounds(
        emu_lib, late_libs, dtype):
    """Equal combo energies whose order decides the tracebacks: the first
    in stems order must win whether the tied combos meet in one round's
    lanes or in different rounds. The committed source equals the plain
    version on these hits, and each build that lets the later combo win at
    one of the two places does not, so the batch holds ties of both
    kinds."""
    args = _synthetic_args("tied", n_hits=3)
    counts, _ovf = _emu_equals_plain_gapped(emu_lib, args, dtype)
    assert counts["combos"] > 32 * counts["diagonals"]
    for at in TIE_RULES:
        with pytest.raises(AssertionError):
            _emu_equals_plain_gapped(late_libs[at], args, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_stamped_build_counts_the_plain_versions_work(tmp_path, tiny_hits,
                                                      dtype):
    """The -DGAPPED_STAMPS build (gapped_ab.py's split) gives the plain
    version's bits and counts its work exactly: hits, diagonals, band and
    admitted cells, combos, rounds, (cell, s) steps and the empty ones, the
    busiest cell's combos per s, and the admitted cells without a finite
    predecessor (the stems[0] fallback, which the tiny hits reach), on the
    tiny-golden hits and the periodic GC-rich ones."""
    lib = _emu_build(tmp_path, sweep_op._SRC,
                     ("gapped_extend_f32", "gapped_extend_f64"),
                     flags=("-DGAPPED_STAMPS",))
    lib.gapped_extend_stamps.restype = ctypes.c_int
    lib.gapped_extend_stamps.argtypes = [ctypes.c_void_p]
    soa, energy, acc, qbufs, dbufs, _stage1 = tiny_hits
    valid = torch.ones(N_HITS, dtype=torch.bool)
    tiny = (soa["q_sp"], soa["db_sp"], soa["dbseq_start"] + soa["db_len"] - 1,
            energy, acc, valid, *(soa[k] for k in ("qb", "qab", "dbb", "aoff",
                                                  "coff")),
            qbufs[0], dbufs[0], qbufs[1], qbufs[2], dbufs[1], dbufs[2])
    out = (ctypes.c_ulonglong * N_STAMPS)()
    for args in (tiny, _synthetic_args("periodic")):
        assert lib.gapped_extend_stamps(out) == 0          # cleared
        counts, _ovf = _emu_equals_plain_gapped(lib, args, dtype)
        assert lib.gapped_extend_stamps(out) == 0
        got = dict(zip(STAMP_KEYS, out))
        assert got.pop("hits") == 2 * len(args[0])
        assert got == counts
        assert all(c > 0 for c in out[len(STAMP_KEYS):])   # cycles stamped
    assert counts["nopred"] > 0
    assert lib.gapped_extend_stamps(out) == 0 and not any(out)


@pytest.mark.parametrize("dropout", [5, 2])
def test_ungapped_kernel_source_matches_plain_version_in_emulation(
        tmp_path, tiny_hits, dropout):
    """Every stage-1 hit of the tiny goldens (plus three padded with
    copies, so the last block is ragged), a thread each: the emulated
    kernel's columns equal the plain version's, float32 energies bit for
    bit; dropout 5 is the default, 2 stops hits earlier."""
    from priblast_tpu_torch.search import ungapped as ung

    lib = _emu_build(tmp_path, ungapped_op._SRC, ("ungapped_extend",))
    _soa, _energy, _acc, qbufs, dbufs, stage1 = tiny_hits
    n = len(stage1["q_sp"])
    sel = np.concatenate([np.arange(n), [0, n // 2, n - 1]])

    def col(k, dtype=torch.int64):
        return torch.as_tensor(stage1[k][sel]).to(dtype).contiguous()

    cols = tuple(col(k) for k in ("q_sp", "db_sp", "q_len", "dbseq_start",
                                  "qb", "qab", "dbb", "aoff", "coff"))
    acc_e, hyb_e = col("acc_e", torch.float32), col("hyb_e", torch.float32)
    plain = ungapped_op.ungapped_extend(*cols[:4], acc_e, hyb_e, *cols[4:],
                                        qbufs, dbufs, 5, dropout)
    flat = (qbufs[0], dbufs[0], qbufs[1], qbufs[2], dbufs[1], dbufs[2])
    emu = ungapped_op._call(lib.ungapped_extend, cols, acc_e, hyb_e, flat, 0,
                            5, dropout)
    assert set(emu) == set(plain)
    for k in plain:
        assert emu[k].dtype == plain[k].dtype, k
        assert torch.equal(emu[k], plain[k]), k
    steps = ung.extend_steps(*cols[:4], acc_e, hyb_e, *cols[4:], qbufs,
                             dbufs, 5, dropout)
    assert int(sum(x.sum() for x in steps)) > 2 * len(sel)  # hits extend


def test_ungapped_kernel_source_keeps_the_first_minimum_on_ties(tmp_path):
    """On exact ties the running minimum keeps its first position (strict
    <, as the reference). The batch holds such ties: the plain version
    with <= in place of < moves their extents. On the tie hits and 200
    others, the emulated kernel equals the plain version bit for bit."""
    from priblast_tpu_torch.search import ungapped as ung

    cols, acc_e, hyb_e, qbufs, dbufs = uc.tie_batch()
    args = (*cols[:4], acc_e, hyb_e, *cols[4:], qbufs, dbufs, 5, 5)
    src = inspect.getsource(ung._extend)
    assert src.count("(e < min_e)") == 2
    scope = dict(vars(ung))
    exec(src.replace("(e < min_e)", "(e <= min_e)"), scope)
    ref = ung.ungapped_extend_flat(*args)
    late = scope["_extend"](*args)[0]
    ties = torch.nonzero(ref["q_len"] != late["q_len"]).squeeze(1)
    assert len(ties) >= 10
    sel = torch.cat([ties, torch.arange(200)])
    sub = [c[sel].contiguous() for c in cols]
    acc_s, hyb_s = acc_e[sel].contiguous(), hyb_e[sel].contiguous()
    flat = (qbufs[0], dbufs[0], qbufs[1], qbufs[2], dbufs[1], dbufs[2])
    lib = _emu_build(tmp_path, ungapped_op._SRC, ("ungapped_extend",))
    emu = ungapped_op._call(lib.ungapped_extend, sub, acc_s, hyb_s, flat, 0,
                            5, 5)
    for k in ref:
        assert torch.equal(emu[k], ref[k][sel]), k


@pytest.fixture(scope="module")
def ungapped_lib(tmp_path_factory):
    return _emu_build(tmp_path_factory.mktemp("ungapped_emu"),
                      ungapped_op._SRC, ("ungapped_extend",))


def _kernel_threads() -> int:
    """Threads per block of the kernel source (kThreads)."""
    return int(re.search(r"constexpr int kThreads = (\d+);",
                         ungapped_op._SRC.read_text()).group(1))


def _emu_equals_plain(lib, part, d=5, dropout=5):
    """The emulated kernel and the plain version on a part: every column
    identical (integers, float32 energies bit for bit); returns the
    arguments."""
    args = uc.args_of(part, d, dropout)
    plain = ungapped_op.ungapped_extend(*args)
    cols, acc_e, hyb_e, (q_enc, q_acc, q_cond), (db_seq, db_acc,
                                                 db_cond) = part
    emu = ungapped_op._call(lib.ungapped_extend, cols, acc_e, hyb_e,
                            (q_enc, db_seq, q_acc, q_cond, db_acc, db_cond),
                            0, d, dropout)
    assert set(emu) == set(plain)
    for k in plain:
        assert emu[k].dtype == plain[k].dtype, k
        assert torch.equal(emu[k], plain[k]), k
    return args


@pytest.fixture(scope="module")
def mixed_part(tiny_hits):
    """The 96 tiny-golden stage-1 hits with the most steps, each among
    three hits of a tie batch of 10-nt windows (fewer steps), over one set
    of buffers."""
    from priblast_tpu_torch.search import ungapped as ung

    _soa, _energy, _acc, qbufs, dbufs, stage1 = tiny_hits
    tiny = uc.stage1_part(stage1, qbufs, dbufs)
    left, right = ung.extend_steps(*uc.args_of(tiny))
    return uc.mixed_batch(tiny, left + right,
                          uc.tie_batch(n_hits=512, length=10))


def test_ungapped_kernel_source_on_a_mixed_batch(ungapped_lib, mixed_part):
    """Long and short hits in every warp, so that lanes stop and switch
    phase while their neighbours still run: the emulated kernel equals the
    plain version bit for bit."""
    from priblast_tpu_torch.search import ungapped as ung

    args = _emu_equals_plain(ungapped_lib, mixed_part)
    left, right = ung.extend_steps(*args)
    steps = (left + right).view(-1, 4)
    assert (steps[:, 0] > steps[:, 1:].max(dim=1).values).float().mean() > 0.5
    assert len(args[0]) > _kernel_threads()


@pytest.mark.parametrize("size", ["1", "31", "33", "block+17"])
def test_ungapped_kernel_source_on_small_and_ragged_batches(
        ungapped_lib, mixed_part, size):
    """Batches of fewer hits than a warp, one more than a warp, and one
    that ends 17 hits into a second block (a warp with idle lanes)."""
    n = _kernel_threads() + 17 if size == "block+17" else int(size)
    assert n <= len(mixed_part[1])
    _emu_equals_plain(ungapped_lib, uc.select(mixed_part, torch.arange(n)))


@pytest.mark.parametrize("dropout", [5, 3])
def test_ungapped_kernel_source_clamps_at_both_buffer_ends(ungapped_lib,
                                                          dropout):
    """Hits whose steps read before the first and past the last entry of
    every flat buffer: the clamped loads equal the plain version's."""
    from priblast_tpu_torch.search import ungapped as ung

    part = uc.clamp_batch()
    args = _emu_equals_plain(ungapped_lib, part, dropout=dropout)
    left, right = ung.extend_steps(*args)
    (q_sp, db_sp, length, dbseq_start, qb, qab, dbb, aoff,
     coff), _a, _h, (q_enc, q_acc, q_cond), (db_seq, db_acc, db_cond) = part
    k0, l0, ids, d = q_sp + length - 1, db_sp + length - 1, dbseq_start, 5
    # the first and the last load of each phase in each buffer
    reach = {
        "q_enc": (qb + q_sp, qb + q_sp - left - 1, qb + k0,
                  qb + k0 + right + 1),
        "db_seq": (dbb + db_sp, dbb + db_sp - left - 1, dbb + l0,
                   dbb + l0 + right + 1),
        "q_acc": (qab + q_sp, qab + q_sp - left - 1),
        "q_cond": (qab + q_sp + d - 1, qab + q_sp + d - left - 1,
                   qab + k0 + 1, qab + k0 + right + 1),
        "db_acc": (aoff + ids, aoff + ids - right - 1),
        "db_cond": (coff + ids + length, coff + ids + length + left,
                    coff + ids + d - 1, coff + ids + d - right - 1),
    }
    sizes = dict(q_enc=len(q_enc), db_seq=len(db_seq), q_acc=len(q_acc),
                 q_cond=len(q_cond), db_acc=len(db_acc), db_cond=len(db_cond))
    for name, ends in reach.items():
        pos = torch.cat(ends)
        assert int(pos.min()) < 0 and int(pos.max()) >= sizes[name], name


def test_ungapped_plain_version_never_reads_int21(tiny_hits, monkeypatch):
    """Both coordinates move together in the ungapped extension (u1 = u2),
    so the plain version never takes its int21 branches, which the kernel
    leaves out: with int21 all NaN, its outputs are the same, on the
    tiny-golden stage-1 hits and on the tie batch."""
    from priblast_tpu_torch.search import ungapped as ung

    _soa, _energy, _acc, qbufs, dbufs, stage1 = tiny_hits
    batches = [uc.args_of(uc.stage1_part(stage1, qbufs, dbufs), 5, d)
               for d in (5, 2)]
    batches.append(uc.args_of(uc.tie_batch()))
    refs = [ung.ungapped_extend_flat(*a) for a in batches]
    tables = ung._tables

    def nan_i21(device):
        t = tables(device)
        t["i21"] = torch.full_like(t["i21"], float("nan"))
        return t

    monkeypatch.setattr(ung, "_tables", nan_i21)
    for a, ref in zip(batches, refs):
        got = ung.ungapped_extend_flat(*a)
        assert bool(torch.isnan(ung._tables("cpu")["i21"]).all())
        for k in ref:
            assert torch.equal(got[k], ref[k]), k



def test_lane_efficiency_of_one_thread_per_hit(mixed_part):
    """chip_smoke.lanes_one_per_hit: the steps of all hits over 32 x the
    sum, over warps of 32 consecutive hits, of the warp's largest step
    count; a last warp with idle lanes counts its largest step count."""
    import chip_smoke
    from priblast_tpu_torch.search import ungapped as ung

    st = torch.tensor([1] * 31 + [4, 2])
    assert chip_smoke.lanes_one_per_hit(st) == 37 / (32 * (4 + 2))
    assert chip_smoke.lanes_one_per_hit(torch.full((64,), 3)) == 1.0
    left, right = ung.extend_steps(*uc.args_of(mixed_part))
    steps = (left + right).tolist()
    warps = [steps[k:k + 32] for k in range(0, len(steps), 32)]
    want = sum(steps) / (32 * sum(max(w) for w in warps))
    assert chip_smoke.lanes_one_per_hit(left + right) == pytest.approx(
        want, rel=1e-12)
    # long and short hits share every warp: sorted by steps, fewer lanes
    # wait
    assert chip_smoke.lanes_one_per_hit(
        (left + right).sort().values) > want
