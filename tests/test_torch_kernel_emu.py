"""The gapped kernel's CUDA source, compiled by g++ against a CPU stand-in
for the CUDA built-ins (tests/cuda_emu/cuda_runtime.h: one warp per block,
one thread per lane), against its plain PyTorch version on the mid-stage
hits of the tiny goldens: integers, traceback lists and floats identical.

This runs the kernel's own arithmetic, indexing and warp-level protocol on
a machine without a card; it does not replace the comparison on the card
(tests/test_torch_gpu.py, chip_smoke.py), where nvcc and the hardware's
warps run it.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from priblast_tpu_torch.models import db as tdb
from priblast_tpu_torch.ops import gapped_sweep as sweep_op
from priblast_tpu_torch.ops import native
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


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed (it also builds the native engine)"
    d = tmp_path_factory.mktemp("kernel_emu")
    src = d / "gapped_extend_emu.cc"
    src.write_text(_emulated_source(sweep_op._SRC.read_text()))
    lib = d / "libgapped_extend_emu.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", str(TESTS / "cuda_emu"), "-o", str(lib),
                    str(src), "-lpthread"], check=True)
    out = ctypes.CDLL(str(lib))
    for name in ("gapped_extend_f32", "gapped_extend_f64"):
        getattr(out, name).restype = ctypes.c_int
        getattr(out, name).argtypes = [ctypes.c_void_p] * 4
    return out


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
    queries, mids = [], []
    for seq in seqs:
        q_acc, q_cond = native.raccess(alphabet.access_codes(seq), 70, 5)
        q_enc = alphabet.encode_query(seq, p.repeat_flag)
        q_sa = native.sa_build(q_enc)
        queries.append((q_enc, q_acc, q_cond))
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
    return soa, energy, acc, qpack.bufs, dbpack.bufs


@pytest.mark.parametrize("dtype,max_ext,dropout,min_helix", [
    ("float32", 32, 16, 3),
    ("float64", 64, 16, 3),
    ("float32", 40, 9, 2),
    ("float64", 24, 9, 2),
])
def test_kernel_source_matches_plain_version_in_emulation(
        emu_lib, tiny_hits, dtype, max_ext, dropout, min_helix):
    soa, energy, acc, qbufs, dbufs = tiny_hits
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
