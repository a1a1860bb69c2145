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
from priblast_tpu_torch.ops import access_grids as ag
from priblast_tpu_torch.ops import access_prob as ap
from priblast_tpu_torch.ops import access_scan as acs
from priblast_tpu_torch.ops import fused_expand as fe
from priblast_tpu_torch.ops import gapped_sweep as sweep_op
from priblast_tpu_torch.ops import native
from priblast_tpu_torch.ops import ungapped_extend as ungapped_op
from priblast_tpu_torch.search import fused, seed
from priblast_tpu_torch.search import gapped as tgapped
from priblast_tpu_torch.search import pipeline as tpl
from priblast_tpu_torch.utils import alphabet, fasta, store
from priblast_tpu_torch.utils import profiling as prof
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
    traceback lists and floats, in both of the kernel's forms: the work
    list at max_ext 32 (whose hits `ris.gapped.worklist_hits` counts), lanes
    at 64 and 120 (max_ext=120 float64 needs more than 48 KB of shared
    memory per block)."""
    dev = _card()
    chunks, queries, mids, _pres = tiny_mids
    qpack = tpl.QueryPack([q[0] for q in queries], [q[2] for q in queries],
                          [q[3] for q in queries], [q[1] for q in queries],
                          devices=dev)
    dbpack = tpl.DbPack(chunks, devices=dev)
    stream = tpl._concat_groups(mids, [(q, 0) for q in range(len(mids))])
    tpl._hit_bases(stream, qpack, dbpack)
    calls = []
    kernel = sweep_op.gapped_extend_dir

    def both(*a, **k):
        out = kernel(*a, **k)
        calls.append((out, sweep_op.extend_dir_plain(*a, **k)))
        return out

    launches = sweep_op.launches
    form = sweep_op.kernel_form(max_ext, dev)
    assert form == ("worklist" if max_ext <= 32 else "lanes")
    by_form = dict(sweep_op.form_launches)
    worklist_hits = prof.counters().get("ris.gapped.worklist_hits", 0)
    try:
        sweep_op.gapped_extend_dir = both
        tgapped.gapped_extend_flat_batch(
            {k: stream.soa[k] for k in HIT_COLS}, qpack.bufs, dbpack.bufs,
            device=dev, max_ext=max_ext, dtype=dtype, **KW)
    finally:
        sweep_op.gapped_extend_dir = kernel
    assert sweep_op.launches == launches + 2 and len(calls) == 2
    assert sweep_op.form_launches == {
        f: n + 2 * (f == form) for f, n in by_form.items()}
    assert prof.counters().get("ris.gapped.worklist_hits", 0) == (
        worklist_hits + len(stream) * (form == "worklist"))
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
                          devices=dev)
    dbpack = tpl.DbPack(chunks, devices=dev)
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
                          devices=cpu)
    dbpack = tpl.DbPack(chunks, devices=cpu)
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
def test_ris_gpu_engine_on_the_card(tmp_path, monkeypatch):
    """`ris --engine gpu` on the card, pinned to the device chain: the
    golden hits and base pairs, energies within the float32 engine's 2e-3,
    through the fused path's ungapped kernel and the CUDA sweep."""
    _card()
    monkeypatch.setenv("PRIBLAST_DEVICE_EXTEND", "1")
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_accessibility_does_not_depend_on_the_batch_on_the_card(dtype):
    """Three sequences in a batch of 8 padded to 512 columns and in one of
    16 padded to 768, with other batch-mates: the same acc and cond bytes.
    Several processes batch their shards otherwise than one process, and
    hold their outputs to its bytes (chip_smoke.py [multiproc])."""
    dev = _card()
    rng = np.random.default_rng(7)
    lens = [int(x) for x in rng.integers(380, 500, 3)]
    seqs = ["".join(rng.choice(list("ACGU"), n)) for n in lens]
    engine = ab.BatchedRaccess(70, 5, dtype=dtype, devices=dev)
    got = []
    for B, n_max in ((8, 512), (16, 768)):
        others = ["".join(rng.choice(list("ACGU"), int(n)))
                  for n in rng.integers(100, n_max + 1, B - 3)]
        codes = np.zeros((B, n_max), np.uint8)
        batch = others[: B // 2] + seqs + others[B // 2:]
        for i, sq in enumerate(batch):
            codes[i, : len(sq)] = alphabet.access_codes(sq)
        acc, cond = engine.run(codes, np.array([len(x) for x in batch]))
        rows = [batch.index(sq) for sq in seqs]
        got.append([(acc[r, : n - 4], cond[r, :n])
                    for r, n in zip(rows, lens)])
    for (a1, c1), (a2, c2) in zip(*got):
        assert a1.tobytes() == a2.tobytes()
        assert c1.tobytes() == c2.tobytes()


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


@pytest.mark.gpu
def test_several_shards_on_the_card_match_one():
    """The dry run of several devices in one process with two shards on
    the one card: the split accessibility batch and the split device chain
    equal one device's, bit for bit, energies included."""
    from priblast_tpu_torch.parallel import dist

    dev = dist.device_list(_card())[0]
    out = dist.dryrun_multichip([dev, dev])
    assert out["exact"] and out["hits"] > 0
    assert out["acc_diff"] == out["energy_diff"] == 0.0


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


def test_kernel_form_follows_max_ext():
    """The wrapper's form, as the kernel's launch chooses it: the work list
    up to max_ext 32 (csrc/gapped_extend.cu kWorkMax), lanes above it, the
    plain version on the CPU."""
    cuda = torch.device("cuda")
    assert [sweep_op.kernel_form(m, cuda) for m in (1, 24, 32, 33, 64, 120)
            ] == ["worklist"] * 3 + ["lanes"] * 3
    assert sweep_op.kernel_form(32, "cpu") is None
    src = sweep_op._SRC.read_text()
    assert (f"constexpr int kWorkMax = {sweep_op.WORKLIST_MAX_EXT};" in src)
    assert "p.max_ext <= kWorkMax ? plan_nc<T, DROP, 1>" in src
    assert "if (p.max_ext <= kWorkMax) return launch_nc<T, DROP, 1>" in src


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


def _prob_inputs(dev, dtype=torch.float32, n_extra=0, rows=None):
    """The probability pass's inputs on `dev`: the scan kernels' (or, on
    the CPU, their plain versions') planes of _access_batch's rows `rows`
    (all where None), padded to n_extra columns past the longest."""
    t, g, s, lens, n_max = _access_batch(dev, dtype=dtype)
    if rows is not None or n_extra:
        idx = torch.as_tensor(rows if rows is not None
                              else range(s.shape[0]), device=dev)
        n_max += n_extra
        s = torch.nn.functional.pad(s.index_select(0, idx), (0, n_extra))
        lens = lens.index_select(0, idx).contiguous()
        g = ab.make_grids(t, s, lens, n_max, 72, dtype)
    ins = acs.inside_scan(t, g, lens, n_max, 72, dtype)
    og, m1 = ab.outside_inputs(t, s, lens, n_max, 72, dtype, g, ins)
    outs = acs.outside_scan(t, og, m1, n_max, 72, dtype)
    return t, g, s, lens, n_max, ins, outs


@pytest.mark.gpu
@pytest.mark.parametrize("w", [5, 2])
@pytest.mark.parametrize("dtype,rtol,etol", [("float64", 1e-12, 1e-9),
                                             ("float32", 1e-4, 2e-3)])
def test_probability_kernel_matches_plain_version_on_the_card(dtype, rtol,
                                                              etol, w):
    """The probability kernel against scan_probabilities on the card, on
    the scan kernels' planes of a ragged batch with two all-padding rows,
    at w = 5 and at w = 2 (the small-loop specials): p_w and p_w1 to rtol
    (float64: only the order of sums of nonnegative terms differs), the
    window energies to etol kcal/mol; one launch per call."""
    dev = _card()
    dt = ab._DTYPES[dtype]
    t, g, s, lens, n_max, ins, outs = _prob_inputs(dev, dt)
    before = ap.prob_launches
    got = ap.window_probs(t, g, s, lens, w, n_max, 72, dt, ins, outs)
    ref = ab.scan_probabilities(t, g, s, lens, w, n_max, 72, dt, ins, outs)
    torch.cuda.synchronize()
    assert ap.prob_launches == before + 1
    for a, b in zip(got, ref):
        err = (a.double() - b.double()).abs()
        lim = rtol * b.double().abs() + torch.finfo(dt).tiny
        assert bool((err <= lim).all())
    kT = ab._linmodel(70).sp.kT
    for a, b in zip(
            ab.accessibility_from_probabilities(*got, lens, w, n_max, kT),
            ab.accessibility_from_probabilities(*ref, lens, w, n_max, kT)):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= etol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_probability_kernel_from_device_memory_on_the_card(dtype):
    """The window kernel's other path, the stem rows read from device
    memory (taken where a tile's rows do not fit in shared memory), at
    w = 5 and 2: the same bits as the staged path (each sum adds the same
    values in the same order)."""
    dev = _card()
    dt = ab._DTYPES[dtype]
    _t, g, s, lens, n_max, ins, outs = _prob_inputs(dev, dt)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for w in (5, 2):
            runs = [ap._prob_call(ap._fn(dt), g, s, lens, w, n_max, 72, dt,
                                  ins, outs, stream, staged=staged)
                    for staged in (True, False)]
            torch.cuda.synchronize()
            for a, b in zip(*runs):
                assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_probability_kernel_row_bits_do_not_depend_on_the_batch_on_the_card(
        dtype):
    """Rows 1 and 4 of the ragged batch alone (a batch of two) and the
    whole batch padded 200 columns further: each row's p_w and p_w1 at its
    window starts have the same bits as in the batch of seven, at w = 5
    and w = 2."""
    dev = _card()
    dt = ab._DTYPES[dtype]
    full = _prob_inputs(dev, dt)
    lens = full[3].tolist()
    for w in (5, 2):
        ref = ap.window_probs(*full[:4], w, *full[4:5], 72, dt, *full[5:])
        for rows, extra in (([1, 4], 0), (None, 200)):
            part = _prob_inputs(dev, dt, extra, rows)
            got = ap.window_probs(*part[:4], w, *part[4:5], 72, dt,
                                  *part[5:])
            for k, r in enumerate(rows if rows is not None
                                  else range(len(lens))):
                for a, b in zip(ref, got):
                    n = lens[r]
                    assert torch.equal(a[1: n + 1, r], b[1: n + 1, k])


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "codes",
                                 "lengths", "window"])
def test_probability_wrapper_rejects_bad_inputs(bad):
    t, g, s, lens, n_max, ins, outs = _prob_inputs("cpu")
    w = 5
    p_w, p_w1 = ap.window_probs(t, g, s, lens, w, n_max, 72, torch.float32,
                                ins, outs)
    assert p_w.shape == p_w1.shape == (n_max + 2, s.shape[0])
    if bad == "dtype":
        outs = (*outs[:4], outs[4].double())
    elif bad == "shape":
        ins = (*ins[:6], ins[6][:-1], ins[7])
    elif bad == "contiguous":
        ins = (ins[0].transpose(0, 1).contiguous().transpose(0, 1),
               *ins[1:])
    elif bad == "codes":
        s = s.int()
    elif bad == "lengths":
        lens = lens + n_max
    else:
        w = 0
    with pytest.raises(ValueError):
        ap.window_probs(t, g, s, lens, w, n_max, 72, torch.float32, ins,
                        outs)


def _grid_ulps(a, b):
    """Largest distance in ulps of two tensors of nonnegative floats."""
    it = torch.int64 if a.dtype == torch.float64 else torch.int32
    return int((a.view(it).long() - b.view(it).long()).abs().max())


def _grids_inputs(dev, dtype):
    """_access_batch's ragged batch on `dev` with its plain inside grids and
    the inputs of the outside grids (multi2, A, B, logZ) from its scan."""
    t, g, s, lens, n_max = _access_batch(dev, dtype=dtype)
    ins = acs.inside_scan(t, g, lens, n_max, 72, dtype)
    logZ = ins[6].gather(0, lens[None, :])[0]
    return t, g, s, lens, n_max, (ins[5], ins[6], ins[7], logZ)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_grids_kernels_match_plain_versions_on_the_card(dtype):
    """Both grid launches against make_grids and make_outside_grids on the
    card, on a ragged batch with two all-padding rows: every plane bit for
    bit, the seed within 2 ulps (expf / exp may round otherwise than
    PyTorch's exp); one launch each per call."""
    dev = _card()
    dt = ab._DTYPES[dtype]
    t, g, s, lens, n_max, args = _grids_inputs(dev, dt)
    before = ag.inside_grids_launches, ag.outside_grids_launches
    got = ag.inside_grids(t, s, lens, n_max, 72, dt)
    og = ab.make_outside_grids(t, s, lens, n_max, 72, dt, g, *args)
    got_o = ag.outside_grids(t, s, lens, n_max, 72, dt, g, *args)
    torch.cuda.synchronize()
    assert (ag.inside_grids_launches, ag.outside_grids_launches) == (
        before[0] + 1, before[1] + 1)
    for ref, out in ((g, got), (og, got_o)):
        for name, a, b in zip(ref._fields, out, ref):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            if name == "seed":
                assert _grid_ulps(a, b) <= 2, name
            else:
                assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("threads,tile", [(256, 32), (512, 16), (96, 7),
                                          (1024, 64), (32, 300)])
def test_grids_outside_launch_geometries_on_the_card(threads, tile):
    """The outside launch (a CTA per row and tile of columns, its inputs
    staged in shared memory) at other geometries than the wrapper's,
    against make_outside_grids on the card: every plane bit for bit, the
    seed within 2 ulps; tiles that straddle the rows' ends (N + 1 = 293
    columns), a tile wider than a row, float32 and float64 in one run."""
    dev = _card()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for dt in (torch.float32, torch.float64):
        t, g, s, lens, n_max, args = _grids_inputs(dev, dt)
        ref = ab.make_outside_grids(t, s, lens, n_max, 72, dt, g, *args)
        m2, A, Bo, logZ = args
        got = ag._grids_call(ag._fn("outside", dt), s, lens, n_max, 72, dt,
                             stream, (g, A, Bo, logZ, m2), threads=threads,
                             tile=tile)
        torch.cuda.synchronize()
        for name, a, b in zip(ref._fields, got, ref):
            if name == "seed":
                assert _grid_ulps(a, b) <= 2, name
            else:
                assert torch.equal(a, b), name


@pytest.mark.gpu
def test_window_probabilities_reads_nothing_back_when_checked():
    """window_probabilities told that the lengths are checked (as
    BatchedRaccess calls it) makes no synchronising call on the card, in
    any of its four wrappers: it runs under
    torch.cuda.set_sync_debug_mode("error"), and gives the bits of the
    call that checks the lengths itself."""
    dev = _card()
    t, _g, s, lens, n_max = _access_batch(dev)
    ab.window_probabilities(70, 5, n_max, torch.float32, s, lens, t,
                            checked=True)  # the wrappers' tables, cached
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ab.window_probabilities(70, 5, n_max, torch.float32, s, lens,
                                      t, checked=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = ab.window_probabilities(70, 5, n_max, torch.float32, s, lens, t)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("side,bad", [
    ("inside", "dtype"), ("inside", "shape"), ("inside", "contiguous"),
    ("inside", "device"), ("inside", "lengths"), ("outside", "dtype"),
    ("outside", "shape"), ("outside", "contiguous"), ("outside", "device"),
    ("outside", "lengths")])
def test_access_grids_wrapper_rejects_bad_inputs(side, bad):
    """inside_grids and outside_grids raise ValueError on a tensor of the
    wrong dtype, shape or device, a non-contiguous one, or lengths past
    n_max; on good CPU inputs they return the plain versions' planes."""
    dt = torch.float32
    t, g, s, lens, n_max, args = _grids_inputs("cpu", dt)
    m2, A, Bo, logZ = args
    if side == "inside":
        got = ag.inside_grids(t, s, lens, n_max, 72, dt)
        assert all(torch.equal(a, b) for a, b in zip(got, g))
    else:
        got = ag.outside_grids(t, s, lens, n_max, 72, dt, g, *args)
        ref = ab.make_outside_grids(t, s, lens, n_max, 72, dt, g, *args)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    if bad == "dtype":
        s, A = (s.int(), A) if side == "inside" else (s, A.double())
    elif bad == "shape":
        if side == "inside":
            lens = lens[:-1]
        else:
            Bo = Bo[:-1]
    elif bad == "contiguous":
        if side == "inside":
            s = s.t().contiguous().t()
        else:
            m2 = m2.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "device":
        if side == "inside":
            lens = lens.to("meta")
        else:
            logZ = logZ.to("meta")
    else:
        lens = lens + n_max                     # past the padded length
    with pytest.raises(ValueError):
        if side == "inside":
            ag.inside_grids(t, s, lens, n_max, 72, dt)
        else:
            ag.outside_grids(t, s, lens, n_max, 72, dt, g, m2, A, Bo, logZ)


@pytest.fixture(scope="module")
def tiny_wave(tmp_path_factory):
    """The tiny goldens' seed candidates (one wave), their parameters and
    queries, and their native stage-1 hits."""
    db_name = str(tmp_path_factory.mktemp("torch_gpu_wave") / "tiny_db")
    tdb.run(DbParams(input=str(DATA / "tiny_db.fa"), db_name=db_name,
                     engine="exact"))
    chunks = store.load_chunks(db_name, 8)
    p = RisParams(input="x", output="y", db_name=db_name, engine="exact")
    p.load_db_params()
    _names, seqs = fasta.read_fasta(DATA / "tiny_q.fa")
    queries = []
    for seq in seqs:
        q_acc, q_cond = native.raccess(alphabet.access_codes(seq),
                                       p.maximal_span,
                                       p.min_accessible_length)
        q_enc = alphabet.encode_query(seq, p.repeat_flag)
        queries.append((q_enc, native.sa_build(q_enc), q_acc, q_cond))
    pres = [native.search_chunk(q[0], q[1], q[2], q[3], chunks[0], p,
                                stage=1) for q in queries]
    return p, chunks, queries, seed.seed_candidates(p, chunks, queries), pres


def _packs(queries, chunks, dev):
    return (tpl.QueryPack([q[0] for q in queries], [q[2] for q in queries],
                          [q[3] for q in queries], [q[1] for q in queries],
                          devices=dev),
            tpl.DbPack(chunks, devices=dev))


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


@pytest.mark.gpu
def test_fused_kernels_match_plain_versions_on_the_card(tiny_wave):
    """The expansion (csrc/fused_expand.cu) against _expand_core on the
    card, bit for bit, on the whole tiny wave and on blocks of 1, 31 and 33
    pairs that start inside a candidate; the threshold's records against
    _thresh_core on the same ungapped output, every field's bits."""
    dev = _card()
    p, chunks, queries, cands, _pres = tiny_wave
    qpack, dbpack = _packs(queries, chunks, dev)
    wb = fused._WaveBuffers(cands, qpack, dbpack, dev)
    d, ml = p.min_accessible_length, p.max_seed_length
    ci = int(torch.nonzero(torch.diff(wb.cum) >= 3)[0])
    o = int(wb.cum[ci]) + 1
    before = fe.expand_launches, fe.threshold_launches
    for lo, n in ((0, wb.tot), (o, 1), (o, 31), (o, 33)):
        got = fe.expand(d, ml, lo, n, wb, qpack, dbpack)
        ref = fused._expand_core(d, ml, lo, n, wb, qpack, dbpack)
        assert list(got) == list(ref) and len(ref["pid"]) > 0
        for k in ref:
            assert torch.equal(_bits(got[k]), _bits(ref[k])), k
        res = ungapped_op.ungapped_extend(
            got["q_sp"], got["db_sp"], got["length"], got["dbseq_start"],
            got["acc_e"].float(), got["hyb_e"].float(), got["qb"],
            got["qab"], got["dbb"], got["aoff"], got["coff"], qpack.bufs,
            dbpack.bufs, d, p.drop_out_length_wo_gap)
        rec = fe.threshold(p, res, got)
        rref = fused._thresh_core(p, res, got)
        assert list(rec) == list(rref)
        for k in rref:
            assert rec[k].dtype == rref[k].dtype, k
            assert np.array_equal(rec[k].view(np.uint8),
                                  rref[k].view(np.uint8)), k
    assert fe.expand_launches == before[0] + 4
    assert fe.threshold_launches == before[1] + 4


@pytest.mark.gpu
@pytest.mark.parametrize("threads", [64, 256])
@pytest.mark.parametrize("grid", [1, 3, 132, 0])
def test_fused_one_pass_kernels_at_several_grids_on_the_card(tiny_wave,
                                                             threads, grid):
    """Both one-pass kernels (a decoupled look-back each) on the card at
    several grids (1 and 3 CTAs taking many tiles in turn, 132, a CTA per
    tile) and tiles of 64 and 256 threads, in blocks of 100 pairs and in
    one block of the whole wave: the expansion's columns bit for bit
    against _expand_core, the threshold's records against _thresh_core."""
    dev = _card()
    p, chunks, queries, cands, _pres = tiny_wave
    qpack, dbpack = _packs(queries, chunks, dev)
    wb = fused._WaveBuffers(cands, qpack, dbpack, dev)
    d, ml = p.min_accessible_length, p.max_seed_length
    thr = p.interaction_energy_threshold
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = fe._lib()
    for o, n in [(o, min(100, wb.tot - o)) for o in range(0, wb.tot, 100)] \
            + [(0, wb.tot)]:
        got = fe.expand_call(lib, d, ml, o, n, wb, qpack, dbpack, stream,
                             threads=threads, grid=grid)
        ref = fused._expand_core(d, ml, o, n, wb, qpack, dbpack)
        assert list(got) == list(ref)
        for k in ref:
            assert torch.equal(_bits(got[k]), _bits(ref[k])), (o, k)
        res = ungapped_op.ungapped_extend(
            got["q_sp"], got["db_sp"], got["length"], got["dbseq_start"],
            got["acc_e"].float(), got["hyb_e"].float(), got["qb"],
            got["qab"], got["dbb"], got["aoff"], got["coff"], qpack.bufs,
            dbpack.bufs, d, p.drop_out_length_wo_gap)
        rec = fe.threshold_call(lib, thr, res, got, stream, threads=threads,
                                grid=grid)
        rref = fused._thresh_core(p, res, got)
        assert list(rec) == list(rref)
        for k in rref:
            assert rec[k].dtype == rref[k].dtype, k
            assert np.array_equal(rec[k].view(np.uint8),
                                  rref[k].view(np.uint8)), (o, k)


@pytest.mark.gpu
@pytest.mark.parametrize("block", [None, 100])
def test_fused_stream_equals_staged_oracle_on_the_card(tiny_wave, block):
    """fused_stage on the card (its expansion and threshold kernels; one
    block, or blocks of 100 pairs) gives the staged oracle's stream
    (native stage 1 -> ungapped_stage -> threshold_stage), every field
    identical in value and dtype."""
    dev = _card()
    p, chunks, queries, cands, pres = tiny_wave
    qpack, dbpack = _packs(queries, chunks, dev)
    got = fused.fused_stage(p, cands, qpack, dbpack, devices=dev,
                            block=block)
    ref = tpl._concat_groups(pres, [(q, 0) for q in range(len(pres))])
    tpl._hit_bases(ref, qpack, dbpack)
    tpl.ungapped_stage(ref, qpack, dbpack, p, device=dev)
    ref = tpl.threshold_stage(ref, p)
    assert len(got) > 0 and got.groups == ref.groups
    for k in tpl.STREAM_KEYS:
        assert got.soa[k].dtype == ref.soa[k].dtype, k
        assert np.array_equal(got.soa[k], ref.soa[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("w", [5, 2, 20])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_epilogue_kernel_matches_plain_version_on_the_card(dtype, w):
    """The epilogue kernel against accessibility_from_probabilities on the
    card, on the kernels' p_w and p_w1 of a ragged batch with padding rows:
    acc and cond bit for bit (both call the same libdevice logf); none of
    it read back when the lengths are checked."""
    dev = _card()
    dt = ab._DTYPES[dtype]
    t, _g, s, lens, n_max = _access_batch(dev, dtype=dt)
    pw = ab.window_probabilities(70, 5, n_max, dt, s, lens, t)
    kT = ab._linmodel(70).sp.kT
    ref = torch.stack(ab.accessibility_from_probabilities(*pw, lens, w,
                                                          n_max, kT))
    before = ap.epilogue_launches
    ap.accessibility(*pw, lens, w, n_max, kT, checked=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ap.accessibility(*pw, lens, w, n_max, kT, checked=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ap.epilogue_launches == before + 2
    assert got.shape == ref.shape and float(ref.abs().max()) > 0
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("w", [5, 2, 20])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_window_energies_match_plain_versions_on_the_card(dtype, w):
    """window_energies on the card, on the scan kernels' planes of a
    ragged batch with padding rows: acc and cond bit for bit with the
    plain epilogue (accessibility_from_probabilities) and with the
    epilogue kernel (accessibility) on the probability kernel's p_w and
    p_w1, and with p_w and p_w1 (asked for) bit for bit with
    window_probs'; against the whole plain chain (scan_probabilities
    first, whose sums take some terms in another order) within 1e-9
    kcal/mol in float64 and 2e-3 in float32. Called with checked=True it
    makes no synchronising call, and the launch counters grow by 2 a
    call: one probability pass whose sum launch carries the energies; no
    epilogue kernel."""
    dev = _card()
    dt = ab._DTYPES[dtype]
    t, g, s, lens, n_max, ins, outs = _prob_inputs(dev, dt)
    kT = ab._linmodel(70).sp.kT
    args = (t, g, s, lens, w, n_max, 72, dt, ins, outs)
    pw = ap.window_probs(*args)
    own = torch.stack(ab.accessibility_from_probabilities(*pw, lens, w,
                                                          n_max, kT))
    two = ap.accessibility(*pw, lens, w, n_max, kT)
    ref = torch.stack(ab.accessibility_from_probabilities(
        *ab.scan_probabilities(*args), lens, w, n_max, kT))
    ap.window_energies(*args, kT, checked=True)
    torch.cuda.synchronize()
    before = (ap.prob_launches + ap.energies_launches, ap.epilogue_launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ap.window_energies(*args, kT, checked=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (ap.prob_launches + ap.energies_launches,
            ap.epilogue_launches) == (before[0] + 2, before[1])
    torch.cuda.synchronize()

    def bits(x):
        return x.view(torch.int32)

    assert got.shape == (2, s.shape[0], n_max) and float(ref.abs().max()) > 0
    assert torch.equal(bits(got), bits(own))
    assert torch.equal(bits(got), bits(two))
    assert float((got - ref).abs().max()) <= (1e-9 if dtype == "float64"
                                              else 2e-3)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        e, p_w, p_w1 = ap._energies_call(
            ap._fn(dt, "access_prob_energies"), *args[1:], kT, stream,
            probs=True)
        torch.cuda.synchronize()
    assert torch.equal(bits(e), bits(got))
    assert torch.equal(p_w, pw[0]) and torch.equal(p_w1, pw[1])
