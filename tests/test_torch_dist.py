"""Several devices in one process (priblast_tpu_torch/parallel/dist.py), on
the CPU, where the shards are [cpu] * k: the device rule, the row split,
the threads, the split device stages against one device (bit for bit) and
against the JAX package on its 8-device CPU mesh, the dry run, the entry
points with two devices, the launch counters under threads, and a static
scan of the port for the device faults one card cannot show."""

import filecmp
import re
import sys
import threading

import numpy as np
import pytest
import torch

# the port runs many small tensor ops here: one intra-op thread per test
# worker avoids oversubscribing the host under pytest-xdist
torch.set_num_threads(1)

from priblast_tpu.accessibility import batched as jb  # noqa: E402
from priblast_tpu.models import db as jdb  # noqa: E402
from priblast_tpu.models import ris as jris  # noqa: E402
from priblast_tpu.parallel import dist as jdist  # noqa: E402
from priblast_tpu.utils.params import DbParams as JDbParams  # noqa: E402
from priblast_tpu.utils.params import RisParams as JRisParams  # noqa: E402
from priblast_tpu_torch.accessibility import batched as tb  # noqa: E402
from priblast_tpu_torch.models import db as tdb  # noqa: E402
from priblast_tpu_torch.models import ris as tris  # noqa: E402
from priblast_tpu_torch.models import ris_gpu  # noqa: E402
from priblast_tpu_torch.ops import access_prob, access_scan  # noqa: E402
from priblast_tpu_torch.ops import gapped_sweep, nvcc  # noqa: E402
from priblast_tpu_torch.ops import ungapped_extend  # noqa: E402
from priblast_tpu_torch.parallel import dist  # noqa: E402
from priblast_tpu_torch.search import fused, seed  # noqa: E402
from priblast_tpu_torch.search import pipeline as tpl  # noqa: E402
from priblast_tpu_torch.utils import alphabet, fasta  # noqa: E402
from priblast_tpu_torch.utils.params import DbParams, RisParams  # noqa: E402
from test_torch_e2e import _parse_acc  # noqa: E402
from test_torch_router import _same_hits  # noqa: E402
from test_torch_ungapped import build_staged  # noqa: E402

CPU = torch.device("cpu")
W_SPAN, D = 70, 5


# ---- the device rule ----------------------------------------------------

@pytest.mark.parametrize("cards,procs,pidx,want", [
    (8, 1, 0, list(range(8))),      # one process takes every card
    (8, 2, 0, [0, 2, 4, 6]),
    (8, 2, 1, [1, 3, 5, 7]),
    (3, 2, 1, [1]),
    (1, 2, 0, [0]),                 # fewer cards than processes: shared
    (1, 2, 1, [0]),
    (2, 4, 3, [1]),
    (1, 1, 0, [0]),
])
def test_local_devices(monkeypatch, cards, procs, pidx, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert dist.local_devices("cuda", pidx, procs) == [
        torch.device("cuda", c) for c in want]
    assert dist.local_devices("cpu", pidx, procs) == [CPU]


def test_local_devices_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        dist.local_devices("cuda")
    with pytest.raises(ValueError):
        dist.local_devices("tpu")


@pytest.mark.parametrize("n,k", [(0, 3), (2, 5), (10, 3), (9, 3), (7, 1),
                                 (64, 8)])
def test_split_rows(n, k):
    rows = dist.split_rows(n, k)
    assert len(rows) == k and rows[0][0] == 0 and rows[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    sizes = [hi - lo for lo, hi in rows]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes)[::-1]
    assert sum(s == 0 for s in sizes) == max(k - n, 0)


# ---- the threads ----------------------------------------------------------

def test_a_failing_shard_ends_the_run():
    """Every shard runs once, on a thread of its own; the first failed
    shard's exception (in shard order) is raised after all have joined,
    and nothing is run again."""
    calls, names = [], set()
    lock = threading.Lock()

    def fn(dev, i):
        with lock:
            calls.append(i)
            names.add(threading.current_thread().name)
        if i in (1, 3):
            raise RuntimeError(f"shard {i} failed")
        return i * 10

    with pytest.raises(RuntimeError, match="shard 1 failed"):
        dist.run_sharded(fn, [(CPU, i) for i in range(5)])
    assert sorted(calls) == list(range(5))
    assert len(names) == 5
    assert dist.run_sharded(fn, [(CPU, 0), (CPU, 2), (CPU, 4)]) == [0, 20, 40]


def test_launch_counters_count_every_thread(monkeypatch):
    """N threads of M launches each add N * M to each kernel's counter."""
    counters = ((vars(access_scan), "inside_launches"),
                (vars(access_scan), "outside_launches"),
                (vars(access_prob), "prob_launches"),
                (vars(ungapped_extend), "launches"),
                (vars(gapped_sweep), "launches"))
    for mod, name in counters:
        monkeypatch.setitem(mod, name, 0)
    n_threads, n_launches = 16, 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_launches):
                for mod, name in counters:
                    nvcc.add_launches(mod, name)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    for mod, name in counters:
        assert mod[name] == n_threads * n_launches, name


# ---- the accessibility batch ----------------------------------------------

@pytest.fixture(scope="module")
def tiny_db(data_dir):
    _names, seqs = fasta.read_fasta(data_dir / "tiny_db.fa")
    n_max = max(len(s) for s in seqs)
    codes = np.zeros((len(seqs), n_max), np.uint8)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = alphabet.access_codes(s)
    return codes, np.array([len(s) for s in seqs], np.int32)


@pytest.fixture(scope="module")
def one_device(tiny_db):
    return {dt: tb.BatchedRaccess(W_SPAN, D, dt, devices=[CPU]).run(*tiny_db)
            for dt in ("float32", "float64")}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("k", [2, 3, 8])
def test_split_accessibility_equals_one_device(tiny_db, one_device, dtype,
                                               k):
    """The 8 tiny_db.fa sequences split over k shards (at k = 8 one row
    each) give one device's acc and cond bit for bit."""
    acc, cond = tb.BatchedRaccess(W_SPAN, D, dtype,
                                  devices=[CPU] * k).run(*tiny_db)
    acc1, cond1 = one_device[dtype]
    assert np.array_equal(acc.view(np.uint32), acc1.view(np.uint32))
    assert np.array_equal(cond.view(np.uint32), cond1.view(np.uint32))


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-3),
                                       ("float64", 5e-6)])
def test_split_accessibility_matches_the_jax_mesh(tiny_db, dtype, tol):
    """Eight shards against the JAX package's BatchedRaccess on its
    8-device CPU mesh (the batch of 8 is sharded, one row per device):
    the float32 bound of 2e-3 kcal/mol; in float64 both engines' float32
    outputs differ by a few float32 ulps (tests/test_torch_accessibility.py
    gives the reason), 5e-6."""
    ja, jc = jb.BatchedRaccess(W_SPAN, D, dtype=dtype,
                               mesh=jdist.make_mesh(8)).run(*tiny_db)
    pa, pc = tb.BatchedRaccess(W_SPAN, D, dtype,
                               devices=[CPU] * 8).run(*tiny_db)
    assert pa.shape == ja.shape
    assert np.abs(pa - ja).max() <= tol
    assert np.abs(pc - jc).max() <= tol


def test_sharded_total_matches_jax():
    """sharded_accessibility's mean accessibility (shard sums added on the
    host) against sharded_accessibility_step's (a psum over the mesh), on
    the dry run's random batch of 16 x 96."""
    rng = np.random.default_rng(1)
    B, n_max = 16, 96
    codes = rng.integers(1, 5, (B, n_max)).astype(np.uint8)
    lengths = np.full(B, n_max, np.int32)
    lengths[::3] = 80
    step = jdist.sharded_accessibility_step(jdist.make_mesh(8), 48, 5, n_max)
    ja, _jc, jtotal = jdist.run_sharded(step, codes, lengths)
    acc, _cond, total = dist.sharded_accessibility([CPU] * 8, 48, 5, codes,
                                                   lengths)
    acc1, _c1, total1 = dist.sharded_accessibility([CPU], 48, 5, codes,
                                                   lengths)
    assert np.abs(acc - np.asarray(ja)).max() <= 2e-3
    assert total == pytest.approx(float(jtotal), abs=2e-3)
    assert total == pytest.approx(float(np.asarray(acc, np.float64).sum())
                                  / lengths.sum(), rel=1e-12)
    assert total1 == pytest.approx(total, rel=1e-12)


# ---- the fused pair blocks and the gapped hit batches ---------------------

@pytest.fixture(scope="module")
def staged(tmp_path_factory, data_dir):
    chunks, p, queries, _qp, _dp, _pres, _posts = build_staged(
        tmp_path_factory.mktemp("torch_dist"), data_dir)
    packs = {k: (tpl.QueryPack([q[0] for q in queries],
                               [q[2] for q in queries],
                               [q[3] for q in queries],
                               [q[1] for q in queries], devices=[CPU] * k),
                 tpl.DbPack(chunks, devices=[CPU] * k)) for k in (1, 3)}
    cands = seed.seed_candidates(p, chunks, queries)
    return chunks, p, queries, packs, cands


def _same_stream(a, b):
    assert a.groups == b.groups
    for k in tpl.STREAM_KEYS:
        assert a.soa[k].dtype == b.soa[k].dtype, k
        assert np.array_equal(a.soa[k], b.soa[k]), k


def test_split_fused_stage_equals_one_device(staged):
    """Three shards per pair block give one device's stream, on blocks of
    the wave's n pairs, n - 1 and n - 2: two of the three split unevenly,
    and the last blocks of the latter two (1 and 2 pairs) are smaller
    than the shards, so shards are empty."""
    _chunks, p, _queries, packs, cands = staged
    qp1, dp1 = packs[1]
    qp3, dp3 = packs[3]
    wb = fused._WaveBuffers(cands, qp1, dp1, CPU)
    one = fused.fused_stage(p, cands, qp1, dp1, devices=[CPU])
    assert len(one) > 0 and wb.tot > 3
    for block in (wb.tot, wb.tot - 1, wb.tot - 2):
        got = fused.fused_stage(p, cands, qp3, dp3, devices=[CPU] * 3,
                                block=block)
        _same_stream(got, one)


@pytest.mark.parametrize("short", [1, 2])
def test_split_gapped_stage_equals_one_device(staged, monkeypatch, short):
    """The gapped stage's hit batches split over three shards give one
    device's finished hits, every field, energies included: batches of
    n - short of the n hits, so the first splits unevenly for one of the
    two cases and the last (`short` hits) leaves a shard empty; max_ext
    = 8 sends hits through the host overflow fallback too."""
    chunks, p, queries, packs, cands = staged
    results = {}
    for k in (1, 3):
        qp, dp = packs[k]
        stream = fused.fused_stage(p, cands, qp, dp, devices=[CPU] * k)
        if k == 3:
            cap = len(results[1][0]) - short
            monkeypatch.setattr(tpl, "gapped_cap", lambda *a, **kw: cap)
        results[k] = tpl.finish_search(stream, p, chunks, queries, qp, dp,
                                       devices=[CPU] * k, max_ext=8)
    (s1, f1), (s3, f3) = results[1], results[3]
    _same_stream(s3, s1)
    assert (s1.soa["q_len"] != s1.soa["pre_q_len"]).any()
    n_hits = 0
    for a, b in zip(f1, f3):
        assert set(a) == set(b)
        for key in a:
            assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), key
        n_hits += len(a["q_sp"])
    assert n_hits > 0


def test_dryrun_multichip_on_eight_cpu_shards():
    out = dist.dryrun_multichip([CPU] * 8)
    assert out["exact"] and out["hits"] > 0
    assert out["acc_diff"] == out["energy_diff"] == 0.0


# ---- the entry points with two devices ------------------------------------

@pytest.mark.parametrize("mode", ["always", "auto"])
def test_ris_on_two_devices(tmp_path, data_dir, golden_dir, monkeypatch,
                            mode):
    """`ris` through its entry point with devices=[cpu, cpu] writes the
    bytes of devices=[cpu], and the hits of the JAX package's
    `--engine tpu` (on its 8-device mesh) in the same mode, at
    tests/test_torch_router.py's limits."""
    q_fa = str(data_dir / "tiny_q.fa")
    db = str(golden_dir / "tiny" / "tiny_db")
    monkeypatch.setenv("PRIBLAST_DEVICE_EXTEND",
                       {"always": "1", "auto": "auto"}[mode])
    n_devs = []
    wins0 = ris_gpu.device_extend_wins

    def wins_rec(n_pairs, threads, n_dev):
        n_devs.append(n_dev)
        return wins0(n_pairs, threads, n_dev)

    monkeypatch.setattr(ris_gpu, "device_extend_wins", wins_rec)
    bodies = {}
    for k in (1, 2):
        out = tmp_path / f"port{k}.txt"
        tris.run(RisParams(input=q_fa, output=str(out), db_name=db,
                           device="cpu"), threads=2, devices=[CPU] * k)
        bodies[k] = out.read_text().splitlines()
    assert bodies[1][3:] == bodies[2][3:] and len(bodies[1]) > 3
    # the router counts distinct devices: two shards on the CPU run at one
    # device's rate, so both runs take the same chain
    assert n_devs == ([1, 1] if mode == "auto" else [])

    out_jax = str(tmp_path / "tpu.txt")
    jris.run(JRisParams(input=q_fa, output=out_jax, db_name=db,
                        algorithm="block", engine="tpu"), threads=2)
    _same_hits(open(out_jax).read().splitlines(), bodies[2])


def test_db_on_two_devices(tmp_path, data_dir, golden_dir):
    """`db` through its entry point with devices=[cpu, cpu] writes the
    bytes of devices=[cpu], and the JAX package's `--engine tpu` files
    (accessibility within the float32 bound, 2e-3 kcal/mol; the rest byte
    for byte)."""
    fa = str(data_dir / "tiny_db.fa")
    names = {}
    for k in (1, 2):
        names[k] = str(tmp_path / f"db{k}")
        tdb.run(DbParams(input=fa, db_name=names[k], device="cpu"),
                devices=[CPU] * k)
    jname = str(tmp_path / "jdb")
    jdb.run(JDbParams(input=fa, db_name=jname, engine="tpu"))
    for ext in ("bas", "seq", "ind", "nam", "acc"):
        assert filecmp.cmp(f"{names[1]}.{ext}", f"{names[2]}.{ext}",
                           shallow=False), ext
    for ext in ("bas", "seq", "ind", "nam"):
        assert filecmp.cmp(f"{jname}.{ext}", f"{names[2]}.{ext}",
                           shallow=False), ext
    for ja, pa in zip(_parse_acc(f"{jname}.acc", 8),
                      _parse_acc(f"{names[2]}.acc", 8)):
        assert len(ja) == len(pa) and np.abs(ja - pa).max() < 2e-3


# ---- the faults one card cannot show --------------------------------------

_BARE_CUDA = re.compile(
    r"""torch\.device\(\s*["']cuda["']\s*\)|device\s*=\s*["']cuda["']"""
    r"""|\.to\(\s*["']cuda["']""")
_NO_DEVICE = re.compile(r"torch\.cuda\.(current_stream|synchronize)\(\s*\)")


def test_the_port_names_its_devices(repo_root):
    """No `.cuda()` (it means the current card, whichever shard runs), no
    bare "cuda" device outside the two modules that pick the cards, and
    no stream or synchronisation without its device."""
    files = sorted((repo_root / "priblast_tpu_torch").rglob("*.py"))
    assert len(files) > 20
    allowed = {repo_root / "priblast_tpu_torch" / "parallel" / "dist.py",
               repo_root / "priblast_tpu_torch" / "utils" / "params.py"}
    for f in files:
        text = f.read_text()
        assert ".cuda()" not in text, f
        assert not _NO_DEVICE.search(text), f
        if f not in allowed:
            assert not _BARE_CUDA.search(text), f
