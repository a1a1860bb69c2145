"""Tests of the port that need a CUDA card (marker `gpu`; they skip
without one), plus the gapped kernel wrapper's input checks, which run
anywhere.

This file imports neither jax nor priblast_tpu and uses no fixture of
tests/conftest.py (which imports jax), so on a machine with a card and no
JAX it runs as

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu
"""

from pathlib import Path

import pytest
import torch

from priblast_tpu_torch import cli
from priblast_tpu_torch.models import db as tdb
from priblast_tpu_torch.ops import gapped_sweep as sweep_op
from priblast_tpu_torch.ops import native
from priblast_tpu_torch.search import gapped as tgapped
from priblast_tpu_torch.search import pipeline as tpl
from priblast_tpu_torch.utils import alphabet, fasta, store
from priblast_tpu_torch.utils.params import DbParams, RisParams

TESTS = Path(__file__).resolve().parent
DATA, GOLDEN = TESTS / "data", TESTS / "golden"
KW = dict(d=5, dropout=16, min_helix=3)
HIT_COLS = (*tpl.STREAM_KEYS, "qb", "qab", "dbb", "aoff", "coff")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tiny_mids(tmp_path_factory):
    """Mid-stage hits of the tiny goldens (native stage 2 + chain_mid)."""
    db_name = str(tmp_path_factory.mktemp("torch_gpu") / "tiny_db")
    tdb.run(DbParams(input=str(DATA / "tiny_db.fa"), db_name=db_name,
                     engine="exact"))
    chunks = store.load_chunks(db_name, 8)
    p = RisParams(input="x", output="y", db_name=db_name, engine="exact")
    p.load_db_params()
    _names, seqs = fasta.read_fasta(DATA / "tiny_q.fa")
    queries, mids = [], []
    for seq in seqs:
        q_acc, q_cond = native.raccess(alphabet.access_codes(seq), 70, 5)
        q_enc = alphabet.encode_query(seq, p.repeat_flag)
        q_sa = native.sa_build(q_enc)
        queries.append((q_enc, q_sa, q_acc, q_cond))
        post = native.search_chunk(q_enc, q_sa, q_acc, q_cond, chunks[0], p,
                                   stage=2)
        mids.append(native.chain_mid(q_enc, chunks[0], p, post))
    return chunks, queries, mids


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,max_ext", [("float32", 32), ("float64", 32),
                                           ("float32", 64), ("float64", 120)])
def test_sweep_kernel_matches_plain_version_on_the_card(tiny_mids, dtype,
                                                        max_ext):
    """The CUDA kernel (one direction, characters to traceback) and the
    plain version, fed the same hits on the card, give identical integers,
    traceback lists and floats (max_ext=120 float64 needs more than 48 KB
    of shared memory per block)."""
    dev = _card()
    chunks, queries, mids = tiny_mids
    qpack = tpl.QueryPack([q[0] for q in queries], [q[2] for q in queries],
                          [q[3] for q in queries], device=dev)
    dbpack = tpl.DbPack(chunks, device=dev)
    stream = tpl._concat_groups(mids, [(q, 0) for q in range(len(mids))])
    tpl._hit_bases(stream, qpack, dbpack)
    calls = []
    kernel = sweep_op.gapped_extend_dir

    def both(*a, **k):
        out = kernel(*a, **k)
        calls.append((out, sweep_op.extend_dir_plain(*a, **k)))
        return out

    launches = sweep_op.launches
    try:
        sweep_op.gapped_extend_dir = both
        tgapped.gapped_extend_flat_batch(
            {k: stream.soa[k] for k in HIT_COLS}, qpack.bufs, dbpack.bufs,
            device=dev, max_ext=max_ext, dtype=dtype, **KW)
    finally:
        sweep_op.gapped_extend_dir = kernel
    assert sweep_op.launches == launches + 2 and len(calls) == 2
    for (ik, fk, tk), (ip, fp, tp) in calls:
        assert torch.equal(ik, ip) and torch.equal(tk, tp)
        assert torch.equal(fk, fp)


@pytest.mark.gpu
def test_ris_gpu_engine_on_the_card(tmp_path):
    """`ris --engine gpu` on the card: the golden hits and base pairs,
    energies within the float32 engine's 2e-3, through the CUDA sweep."""
    _card()
    out = tmp_path / "gpu.txt"
    before = sweep_op.launches
    cli.main(["ris", "-i", str(DATA / "tiny_q.fa"), "-o", str(out), "-d",
              str(GOLDEN / "tiny" / "tiny_db")])
    assert sweep_op.launches > before
    got = out.read_text().splitlines()
    gold = (GOLDEN / "tiny" / "predictions.txt").read_text().splitlines()
    assert len(got) == len(gold)
    for lg, lt in zip(gold[3:], got[3:]):
        fg, ft = lg.split(","), lt.split(",")
        assert fg[:5] == ft[:5] and fg[8:] == ft[8:]
        assert all(abs(float(a) - float(b)) < 2e-3
                   for a, b in zip(fg[5:8], ft[5:8]))


def _sweep_args(B=3, max_ext=8, dropout=4, dtype=torch.float32):
    ME1, XW = max_ext + 1, max_ext + 3
    return (torch.zeros((B, sweep_op.N_FPLANES, ME1, max_ext), dtype=dtype),
            torch.zeros((B, ME1, max_ext), dtype=torch.int32),
            torch.zeros((B, XW), dtype=dtype),
            torch.zeros((B, XW), dtype=dtype),
            torch.zeros((B, 4), dtype=torch.int32),
            torch.zeros((B, 2), dtype=dtype),
            torch.zeros((2, dropout + 1), dtype=dtype), 0.5), \
        dict(dropout=dropout, max_ext=max_ext)


def _extend_args(B=3, n=40):
    """Arguments of gapped_extend_dir on the CPU: B hits over flat buffers
    of n entries."""
    cols = [torch.full((B,), 5, dtype=torch.int64) for _ in range(3)]
    energy = [torch.zeros(B, dtype=torch.float64) for _ in range(2)]
    bases = [torch.ones(B, dtype=torch.int64) for _ in range(5)]
    bufs = [torch.full((n,), 2, dtype=torch.int64) for _ in range(2)]
    bufs += [torch.zeros(n, dtype=torch.float32) for _ in range(4)]
    args = (*cols, *energy, torch.ones(B, dtype=torch.bool), *bases, *bufs)
    return list(args), dict(flag=0, d=5, dropout=4, min_helix=3, max_ext=8)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "max_ext"])
def test_sweep_wrapper_rejects_bad_inputs(bad):
    args, kw = _extend_args()
    if bad == "dtype":
        args[0] = args[0].int()                 # q_start
    elif bad == "shape":
        args[6] = args[6][:2]                   # qb
    elif bad == "contiguous":
        args[13] = torch.zeros((40, 3))[:, 0]   # q_acc
    else:
        kw["max_ext"] = 121
    with pytest.raises(ValueError):
        sweep_op.gapped_extend_dir(*args, **kw)


def test_sweep_plain_on_invalid_hits_keeps_inputs():
    """Hits flagged invalid never start: no predecessor row, results are
    their inputs (the padding contract of the sweep)."""
    args, kw = _sweep_args()
    args[5][:] = torch.tensor([-3.0, 1.5])
    pred, ints, floats = sweep_op.sweep_plain(*args, **kw)
    assert (pred == -1).all()
    assert (ints == 0).all()
    assert torch.equal(floats, args[5])
