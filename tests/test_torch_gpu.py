"""Tests of the port that need a CUDA card (marker `gpu`; they skip
without one), plus the kernel wrappers' input checks, which run anywhere.

This file imports neither jax nor priblast_tpu and uses no fixture of
tests/conftest.py (which imports jax), so on a machine with a card and no
JAX it runs as

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import ungapped_cases as uc

from priblast_tpu_torch import cli
from priblast_tpu_torch.accessibility import batched as ab
from priblast_tpu_torch.models import db as tdb
from priblast_tpu_torch.ops import access_scan as acs
from priblast_tpu_torch.ops import gapped_sweep as sweep_op
from priblast_tpu_torch.ops import native
from priblast_tpu_torch.ops import ungapped_extend as ungapped_op
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
    """Mid-stage hits of the tiny goldens (native stage 2 + chain_mid), and
    their stage-1 hits (native stage 1)."""
    db_name = str(tmp_path_factory.mktemp("torch_gpu") / "tiny_db")
    tdb.run(DbParams(input=str(DATA / "tiny_db.fa"), db_name=db_name,
                     engine="exact"))
    chunks = store.load_chunks(db_name, 8)
    p = RisParams(input="x", output="y", db_name=db_name, engine="exact")
    p.load_db_params()
    _names, seqs = fasta.read_fasta(DATA / "tiny_q.fa")
    queries, mids, pres = [], [], []
    for seq in seqs:
        q_acc, q_cond = native.raccess(alphabet.access_codes(seq), 70, 5)
        q_enc = alphabet.encode_query(seq, p.repeat_flag)
        q_sa = native.sa_build(q_enc)
        queries.append((q_enc, q_sa, q_acc, q_cond))
        pres.append(native.search_chunk(q_enc, q_sa, q_acc, q_cond,
                                        chunks[0], p, stage=1))
        post = native.search_chunk(q_enc, q_sa, q_acc, q_cond, chunks[0], p,
                                   stage=2)
        mids.append(native.chain_mid(q_enc, chunks[0], p, post))
    return chunks, queries, mids, pres


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
    chunks, queries, mids, _pres = tiny_mids
    qpack = tpl.QueryPack([q[0] for q in queries], [q[2] for q in queries],
                          [q[3] for q in queries], [q[1] for q in queries],
                          device=dev)
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
@pytest.mark.parametrize("dropout", [5, 2])
def test_ungapped_kernel_matches_plain_version_on_the_card(tiny_mids,
                                                           dropout):
    """The ungapped CUDA kernel (a thread per hit) and its plain version,
    fed the tiny goldens' stage-1 hits on the card, give identical
    integers and float32 energies."""
    dev = _card()
    chunks, queries, _mids, pres = tiny_mids
    qpack = tpl.QueryPack([q[0] for q in queries], [q[2] for q in queries],
                          [q[3] for q in queries], [q[1] for q in queries],
                          device=dev)
    dbpack = tpl.DbPack(chunks, device=dev)
    stream = tpl._concat_groups(pres, [(q, 0) for q in range(len(pres))])
    tpl._hit_bases(stream, qpack, dbpack)

    def col(k, dtype=torch.int64):
        return torch.as_tensor(stream.soa[k], device=dev).to(dtype)

    args = (col("q_sp"), col("db_sp"), col("q_len"), col("dbseq_start"),
            col("acc_e", torch.float32), col("hyb_e", torch.float32),
            *(col(k) for k in ("qb", "qab", "dbb", "aoff", "coff")),
            qpack.bufs, dbpack.bufs, 5, dropout)
    launches = ungapped_op.launches
    got = ungapped_op.ungapped_extend(*args)
    ref = ungapped_op.ungapped_extend_flat(*args)
    empty = ungapped_op.ungapped_extend(*(
        a[:0] if torch.is_tensor(a) else a for a in args))
    torch.cuda.synchronize()
    assert ungapped_op.launches == launches + 1
    assert all(v.numel() == 0 for v in empty.values())
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.gpu
def test_ungapped_kernel_on_a_mixed_batch_on_the_card(tiny_mids):
    """The ungapped kernel on a batch in which long hits (the tiny
    goldens' stage-1 hits with the most steps) share every warp with short
    ones (a tie batch of 10-nt windows), and on its first 1, 31 and 33
    hits: the kernel's columns equal the plain version's on the card."""
    from priblast_tpu_torch.search import ungapped as ung

    dev = _card()
    chunks, queries, _mids, pres = tiny_mids
    cpu = torch.device("cpu")
    qpack = tpl.QueryPack([q[0] for q in queries], [q[2] for q in queries],
                          [q[3] for q in queries], [q[1] for q in queries],
                          device=cpu)
    dbpack = tpl.DbPack(chunks, device=cpu)
    stream = tpl._concat_groups(pres, [(q, 0) for q in range(len(pres))])
    tpl._hit_bases(stream, qpack, dbpack)
    tiny = uc.stage1_part(stream.soa, qpack.bufs, dbpack.bufs)
    left, right = ung.extend_steps(*uc.args_of(tiny))
    mixed = uc.mixed_batch(tiny, left + right,
                           uc.tie_batch(n_hits=512, length=10))

    def on_card(x):
        if torch.is_tensor(x):
            return x.to(dev)
        return tuple(map(on_card, x)) if isinstance(x, tuple) else x

    for n in (len(mixed[1]), 1, 31, 33):
        args = on_card(uc.args_of(uc.select(mixed, torch.arange(n))))
        got = ungapped_op.ungapped_extend(*args)
        ref = ungapped_op.ungapped_extend_flat(*args)
        torch.cuda.synchronize()
        for k in ref:
            assert torch.equal(got[k], ref[k]), (n, k)


@pytest.mark.gpu
def test_ris_gpu_engine_on_the_card(tmp_path):
    """`ris --engine gpu` on the card: the golden hits and base pairs,
    energies within the float32 engine's 2e-3, through the fused path's
    ungapped kernel and the CUDA sweep."""
    _card()
    out = tmp_path / "gpu.txt"
    before = sweep_op.launches, ungapped_op.launches
    cli.main(["ris", "-i", str(DATA / "tiny_q.fa"), "-o", str(out), "-d",
              str(GOLDEN / "tiny" / "tiny_db")])
    assert sweep_op.launches > before[0]
    assert ungapped_op.launches > before[1]
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


def _ungapped_args(B=3, n=40):
    """Arguments of ungapped_extend on the CPU: B hits over flat buffers of
    n entries."""
    cols = [torch.full((B,), 5, dtype=torch.int64) for _ in range(4)]
    energy = [torch.zeros(B, dtype=torch.float32) for _ in range(2)]
    bases = [torch.ones(B, dtype=torch.int64) for _ in range(5)]
    bufs = (torch.full((n,), 2, dtype=torch.int64),
            torch.zeros(n, dtype=torch.float32),
            torch.zeros(n, dtype=torch.float32))
    return [*cols, *energy, *bases, bufs, tuple(bufs), 5, 5]


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "bufs"])
def test_ungapped_wrapper_rejects_bad_inputs(bad):
    args = _ungapped_args()
    assert set(ungapped_op.ungapped_extend(*args)) == set(
        ungapped_op.INT_KEYS + ungapped_op.FLOAT_KEYS)
    if bad == "dtype":
        args[4] = args[4].double()              # acc_e
    elif bad == "shape":
        args[6] = args[6][:2]                   # qb
    elif bad == "contiguous":
        args[0] = torch.zeros((3, 2), dtype=torch.int64)[:, 0]  # q_sp
    else:
        args[12] = (args[12][0].int(), *args[12][1:])  # db_seq
    with pytest.raises(ValueError):
        ungapped_op.ungapped_extend(*args)


def test_ungapped_wrapper_rejects_sizes_past_32_bits():
    """The kernel indexes in 32 bits: a flat buffer or a batch of more
    than MAX_ENTRIES = 2^30 entries raises ValueError (sizes given, not
    allocated), and ungapped_extend makes the same check."""
    sizes = {name: ungapped_op.MAX_ENTRIES for name in ungapped_op._BUFS}
    ungapped_op.check_sizes(ungapped_op.MAX_ENTRIES, sizes)
    for name in ungapped_op._BUFS:
        with pytest.raises(ValueError, match=name):
            ungapped_op.check_sizes(5, {**sizes, name: 2 ** 31})
    with pytest.raises(ValueError, match="batch"):
        ungapped_op.check_sizes(ungapped_op.MAX_ENTRIES + 1, sizes)
    calls = []
    check = ungapped_op.check_sizes
    try:
        ungapped_op.check_sizes = lambda B, s: calls.append((B, s))
        ungapped_op.ungapped_extend(*_ungapped_args())
    finally:
        ungapped_op.check_sizes = check
    assert calls == [(3, dict.fromkeys(ungapped_op._BUFS, 40))]


def _access_batch(dev, n_seq=5, pad_rows=2, dtype=torch.float32):
    """The first n_seq tiny_db.fa sequences (ragged lengths) and pad_rows
    all-padding rows of length 0, as BatchedRaccess.run pads them: the
    tables, grids, padded codes and lengths on `dev`."""
    _names, seqs = fasta.read_fasta(DATA / "tiny_db.fa")
    seqs = seqs[:n_seq]
    n_max = max(len(q) for q in seqs)
    B = n_seq + pad_rows
    s = np.zeros((B, n_max + ab.ML + 4), np.int64)
    for i, q in enumerate(seqs):
        s[i, 1: len(q) + 1] = alphabet.access_codes(q)
    s = torch.as_tensor(s, device=dev)
    lens = torch.tensor([len(q) for q in seqs] + [0] * pad_rows,
                        dtype=torch.int64, device=dev)
    t = ab.make_tables(70, dtype, dev)
    g = ab.make_grids(t, s, lens, n_max, 72, dtype)
    return t, g, s, lens, n_max


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol,etol", [("float64", 1e-12, 1e-9),
                                             ("float32", 1e-4, 2e-3)])
def test_access_kernels_match_plain_versions_on_the_card(dtype, rtol, etol):
    """Both scan kernels against their plain versions on the card, on a
    ragged batch with two all-padding rows: every plane, A and B to rtol
    (float64: only the order of sums of nonnegative terms differs), and
    the window energies of the kernel chain against the plain chain's to
    etol kcal/mol."""
    dev = _card()
    dt = ab._DTYPES[dtype]
    t, g, s, lens, n_max = _access_batch(dev, dtype=dt)
    args = (t, g, lens, n_max, 72, dt)
    before = acs.inside_launches, acs.outside_launches
    ins_k = acs.inside_scan(*args)
    ins_p = acs.inside_plain(*args)
    og, m1 = ab.outside_inputs(t, s, lens, n_max, 72, dt, g, ins_p)
    outs_k = acs.outside_scan(t, og, m1, n_max, 72, dt)
    outs_p = acs.outside_plain(t, og, m1, n_max, 72, dt)
    og_k, m1_k = ab.outside_inputs(t, s, lens, n_max, 72, dt, g, ins_k)
    chain = acs.outside_scan(t, og_k, m1_k, n_max, 72, dt)
    torch.cuda.synchronize()
    assert (acs.inside_launches, acs.outside_launches) == (
        before[0] + 1, before[1] + 2)
    for got, ref in zip((*ins_k, *outs_k), (*ins_p, *outs_p)):
        err = (got.double() - ref.double()).abs()
        lim = rtol * ref.double().abs() + torch.finfo(dt).tiny
        assert bool((err <= lim).all())
    kT = ab._linmodel(70).sp.kT

    def energies(ins, outs):
        pw = ab.scan_probabilities(t, g, s, lens, 5, n_max, 72, dt, ins,
                                   outs)
        return ab.accessibility_from_probabilities(*pw, lens, 5, n_max, kT)

    for a, b in zip(energies(ins_k, chain), energies(ins_p, outs_p)):
        assert float((a - b).abs().max()) <= etol


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "device",
                                 "lengths"])
def test_access_inside_wrapper_rejects_bad_inputs(bad):
    t, g, _s, lens, n_max = _access_batch("cpu", n_seq=2, pad_rows=0)
    ins = acs.inside_scan(t, g, lens, n_max, 72, torch.float32)
    assert len(ins) == 8 and ins[7].shape == (n_max + 1, 2)
    if bad == "dtype":
        g = g._replace(hpW=g.hpW.double())
    elif bad == "shape":
        g = g._replace(t1_nz=g.t1_nz[:, :1])
    elif bad == "contiguous":
        g = g._replace(sp11=g.sp11.transpose(0, 1).contiguous()
                       .transpose(0, 1))
    elif bad == "device":
        lens = lens.to("meta")
    else:
        lens = lens + n_max                     # past the padded length
    with pytest.raises(ValueError):
        acs.inside_scan(t, g, lens, n_max, 72, torch.float32)


@pytest.mark.parametrize("bad", ["dtype", "shape", "multi1"])
def test_access_outside_wrapper_rejects_bad_inputs(bad):
    t, g, s, lens, n_max = _access_batch("cpu", n_seq=2, pad_rows=0)
    ins = acs.inside_scan(t, g, lens, n_max, 72, torch.float32)
    og, m1 = ab.outside_inputs(t, s, lens, n_max, 72, torch.float32, g, ins)
    assert len(acs.outside_scan(t, og, m1, n_max, 72, torch.float32)) == 5
    if bad == "dtype":
        og = og._replace(valid_int=og.valid_int.float())
    elif bad == "shape":
        og = og._replace(seed=og.seed[:-1])
    else:
        m1 = m1.double()
    with pytest.raises(ValueError):
        acs.outside_scan(t, og, m1, n_max, 72, torch.float32)
