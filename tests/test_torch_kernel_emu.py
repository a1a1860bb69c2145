"""The CUDA kernels' sources, compiled by g++ against a CPU stand-in for
the CUDA built-ins (tests/cuda_emu/cuda_runtime.h: one std::thread per
CUDA thread), against their plain PyTorch versions on the tiny goldens:
the gapped kernel (one warp per block) on the mid-stage hits, integers,
traceback lists and floats identical; the ungapped kernel (a thread per
hit) on the stage-1 hits, integers and float32 energies identical.

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
    dynamic shared memory defined in its namespace."""
    out, n = re.subn(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+), [^>]+>>>\((\w+)\);",
                     r"emu_launch(\1, \2, \3, \4, \5);", src)
    assert n == 1, "the kernel launch was not found"
    return out.replace("namespace {", "namespace {\nunsigned char "
                       "smem[kEmuSmem] __attribute__((aligned(16)));", 1)


def _emu_build(d: Path, src: Path, entry_points) -> ctypes.CDLL:
    """g++ build of a kernel source against tests/cuda_emu/; the C entry
    points take (ptrs, sizes, iparams, stream) and return an int."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed (it also builds the native engine)"
    emu = d / f"{src.stem}_emu.cc"
    emu.write_text(_emulated_source(src.read_text()))
    lib = d / f"lib{src.stem}_emu.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", str(TESTS / "cuda_emu"), "-o", str(lib),
                    str(emu), "-lpthread"], check=True)
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
    qpack = tpl.QueryPack(*zip(*queries), device=cpu)
    dbpack = tpl.DbPack(chunks, device=cpu)
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
    ("float64", 64, 16, 3),
    ("float32", 40, 9, 2),
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


def _tie_batch(n_hits=20000, length=24, seed=1):
    """Random query/db windows around a G-C seed with zero accessibility,
    so every energy change is a loop energy: some hits reach an earlier
    minimum again exactly (a loop energy and a later one cancel)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(2, 6, (n_hits, length))
    d = rng.integers(2, 6, (n_hits, length))
    mid = length // 2
    q[:, mid], d[:, mid] = 4, 3
    base = np.arange(n_hits) * (length + 1) + 1
    qbuf = np.zeros(n_hits * (length + 1) + 8, np.int64)
    dbuf = np.zeros_like(qbuf)
    qbuf[base[:, None] + np.arange(length)] = q
    dbuf[base[:, None] + np.arange(length)] = d
    zero = torch.zeros(len(qbuf), dtype=torch.float32)

    def i64(a):
        return torch.as_tensor(np.broadcast_to(a, (n_hits,)).copy(),
                               dtype=torch.int64)

    cols = (i64(mid), i64(mid), i64(1), i64(length // 4), i64(base),
            i64(base), i64(base), i64(0), i64(0))
    return (cols, torch.zeros(n_hits), torch.full((n_hits,), -4.0),
            (torch.as_tensor(qbuf), zero, zero),
            (torch.as_tensor(dbuf), zero, zero))


def test_ungapped_kernel_source_keeps_the_first_minimum_on_ties(tmp_path):
    """On exact ties the running minimum keeps its first position (strict
    <, as the reference). The batch holds such ties: the plain version
    with <= in place of < moves their extents. On the tie hits and 200
    others, the emulated kernel equals the plain version bit for bit."""
    from priblast_tpu_torch.search import ungapped as ung

    cols, acc_e, hyb_e, qbufs, dbufs = _tie_batch()
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
