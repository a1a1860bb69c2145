"""The port's ris host/device router (models/ris_gpu.py) against the JAX
package's (priblast_tpu/models/ris_tpu.py): the cases of
tests/test_router.py on the port's module, split_wave and
device_extend_wins on the same seeded inputs with both modules' constants
and calibration set alike (their default rates differ on purpose: the
port's are measured on its own card), and `ris --device cpu` in each mode
of PRIBLAST_DEVICE_EXTEND against the JAX package's `--engine tpu` run in
the same mode. Also: a failure of the device side ends the run, and the
stage timers count stages from several threads."""

import importlib
import os
import sys
import threading

import numpy as np
import pytest
import torch

# the port runs many small tensor ops here: one intra-op thread per test
# worker avoids oversubscribing the host under pytest-xdist
torch.set_num_threads(1)

from priblast_tpu.models import ris as jris  # noqa: E402
from priblast_tpu.models import ris_tpu  # noqa: E402
from priblast_tpu.utils.params import RisParams as JRisParams  # noqa: E402
from priblast_tpu_torch import cli  # noqa: E402
from priblast_tpu_torch.models import ris as tris  # noqa: E402
from priblast_tpu_torch.models import ris_gpu  # noqa: E402
from priblast_tpu_torch.ops import native  # noqa: E402
from priblast_tpu_torch.utils import alphabet, fasta, store  # noqa: E402
from priblast_tpu_torch.utils import profiling as prof  # noqa: E402
from priblast_tpu_torch.utils.params import RisParams  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture()
def rt(monkeypatch):
    monkeypatch.setitem(ris_gpu._CAL, "host", None)
    monkeypatch.setitem(ris_gpu._CAL, "dev", None)
    return ris_gpu


@pytest.fixture()
def env_rates(monkeypatch):
    """Set PRIBLAST_<rate> variables and reload both routers, which read
    them at import; both are reloaded again from a clean environment
    afterwards."""
    def set_rates(**rates):
        for name, value in rates.items():
            monkeypatch.setenv(f"PRIBLAST_{name}", str(value))
        for mod in (ris_gpu, ris_tpu):
            importlib.reload(mod)

    yield set_rates
    monkeypatch.undo()
    for mod in (ris_gpu, ris_tpu):
        importlib.reload(mod)


# ---- the cases of tests/test_router.py on the port's router --------------

def test_env_rates_flip_the_router(env_rates):
    """A platform whose device rates are 100x another's flips the
    winner-take-all estimate through the environment alone."""
    n_pairs, threads = 10_000_000, 2
    slow = dict(HOST_PAIR_RATE=2e5, DEV_PAIR_RATE=1e6, DEV_HIT_RATE=1e4,
                HIT_DENSITY=0.1, DEV_DISPATCH_S=0.1)
    env_rates(**slow)
    assert not ris_gpu.device_extend_wins(n_pairs, threads, 1)
    env_rates(DEV_PAIR_RATE=100 * slow["DEV_PAIR_RATE"],
              DEV_HIT_RATE=100 * slow["DEV_HIT_RATE"])
    assert ris_gpu.device_extend_wins(n_pairs, threads, 1)


def test_split_wave_balances_by_rate(rt, monkeypatch):
    pairs = {q: 1_000_000 for q in range(10)}
    monkeypatch.setattr(rt, "DEV_DISPATCH_S", 0.15)
    # device ~1/3 of the 2-thread host rate -> ~1/4 of the queries
    monkeypatch.setitem(rt._CAL, "host", 1_000_000.0)
    monkeypatch.setitem(rt._CAL, "dev", 333_000.0)
    host_ids, dev_ids = rt.split_wave(pairs, threads=2, n_dev=1)
    assert sorted(host_ids + dev_ids) == list(range(10))
    assert 1 <= len(dev_ids) <= 4

    # a 10x-faster device flips the proportions
    monkeypatch.setitem(rt._CAL, "dev", 10_000_000.0)
    host_ids, dev_ids = rt.split_wave(pairs, threads=2, n_dev=1)
    assert len(dev_ids) >= 8


def test_split_wave_small_waves_stay_host(rt, monkeypatch):
    # the fixed device dispatch cost keeps tiny waves off the device
    monkeypatch.setattr(rt, "DEV_DISPATCH_S", 0.15)
    monkeypatch.setitem(rt._CAL, "host", 1_000_000.0)
    monkeypatch.setitem(rt._CAL, "dev", 1_000_000.0)
    host_ids, dev_ids = rt.split_wave({0: 1000, 1: 500}, threads=2,
                                      n_dev=1)
    assert dev_ids == [] and sorted(host_ids) == [0, 1]


def test_calibration_updates_rates(rt):
    rt._calibrate("dev", 1_000_000, 2.0)
    assert rt._CAL["dev"] == pytest.approx(500_000.0)
    rt._calibrate("dev", 1_000_000, 1.0)   # EMA moves halfway
    assert rt._CAL["dev"] == pytest.approx(750_000.0)
    rt._calibrate("host", 0, 1.0)          # no pairs -> no update
    assert rt._CAL["host"] is None


# ---- parity with the JAX package's router --------------------------------

@pytest.mark.parametrize("n_dev", [1, 2, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_and_choice_match_the_jax_router(monkeypatch, seed, n_dev):
    """The device count enters both routers as the JAX package's mesh size
    does (ris_tpu.py:216): 1, 2 and 8 devices."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        rates = dict(HOST_PAIR_RATE=float(rng.uniform(1e4, 1e6)),
                     DEV_PAIR_RATE=float(rng.uniform(1e5, 1e8)),
                     DEV_HIT_RATE=float(rng.uniform(1e3, 1e6)),
                     HIT_DENSITY=float(rng.uniform(0.0, 0.3)),
                     DEV_DISPATCH_S=float(rng.uniform(0.0, 0.5)))
        cal = {"host": None, "dev": None}
        if rng.random() < 0.5:
            cal = {"host": float(rng.uniform(1e4, 1e7)),
                   "dev": float(rng.uniform(1e4, 1e7))}
        for mod in (ris_gpu, ris_tpu):
            for name, value in rates.items():
                monkeypatch.setattr(mod, name, value)
            for side, value in cal.items():
                monkeypatch.setitem(mod._CAL, side, value)
        n_q = int(rng.integers(1, 60))
        # ties and empty queries included
        pairs = {q: int(rng.choice([0, 1000, int(rng.integers(1, 10**7))]))
                 for q in range(n_q)}
        threads = int(rng.integers(1, 33))
        assert (ris_gpu.split_wave(pairs, threads, n_dev)
                == ris_tpu.split_wave(pairs, threads, n_dev))
        n = int(rng.integers(0, 10**9))
        assert (ris_gpu.device_extend_wins(n, threads, n_dev)
                == ris_tpu.device_extend_wins(n, threads, n_dev))


def test_device_extend_mode_reads_the_environment_at_each_call(monkeypatch):
    for value, mode in (("1", "always"), ("true", "always"), ("0", "never"),
                        ("never", "never"), ("auto", "auto"), ("", "auto")):
        monkeypatch.setenv("PRIBLAST_DEVICE_EXTEND", value)
        assert ris_gpu.device_extend_mode() == ris_tpu.device_extend_mode() \
            == mode
    monkeypatch.delenv("PRIBLAST_DEVICE_EXTEND")
    assert ris_gpu.device_extend_mode() == "auto"


@pytest.fixture()
def tiny_wave(data_dir, golden_dir):
    """(p, chunks, queries) of the tiny goldens, as route() takes them."""
    p = RisParams(input=str(data_dir / "tiny_q.fa"), output="-",
                  db_name=str(golden_dir / "tiny" / "tiny_db"), device="cpu")
    p.load_db_params()
    chunks = store.load_chunks(p.db_name, p.hash_size)
    queries = []
    for seq in fasta.read_fasta(p.input)[1]:
        q_enc = alphabet.encode_query(seq, p.repeat_flag)
        queries.append((q_enc, native.sa_build(q_enc), *native.raccess(
            alphabet.access_codes(seq), p.maximal_span,
            p.min_accessible_length)))
    return p, chunks, queries


def test_route_counts_a_repeated_device_once(rt, monkeypatch, tiny_wave):
    """route() with devices=[cpu, cpu] (two shards on one device) splits as
    with [cpu]: the rate counts distinct devices, as the JAX package's
    mesh does, in the hybrid split and in the winner-take-all choice. The
    rates make the device side's width decide both."""
    p, chunks, queries = tiny_wave
    seen = []
    for name in ("split_wave", "device_extend_wins"):
        def rec(pairs, threads, n_dev, _fn=getattr(rt, name)):
            seen.append(n_dev)
            return _fn(pairs, threads, n_dev)

        monkeypatch.setattr(rt, name, rec)
    pairs = rt.route(p, chunks, queries, "auto", [CPU], 4)[3]
    total = sum(pairs.values())
    assert total > 0
    # the device side, at one device, a little slower than the host's 4
    # threads, so that a second device would flip the choices
    monkeypatch.setattr(rt, "DEV_DISPATCH_S", 0.0)
    monkeypatch.setattr(rt, "HIT_DENSITY", 0.0)
    monkeypatch.setattr(rt, "HOST_PAIR_RATE", 1e6)
    monkeypatch.setattr(rt, "DEV_PAIR_RATE", 3.5e6)
    for hyb in ("0", "1"):
        monkeypatch.setenv("PRIBLAST_HYBRID", hyb)
        seen.clear()
        one = rt.route(p, chunks, queries, "auto", [CPU], 4)
        two = rt.route(p, chunks, queries, "auto", [CPU, CPU], 4)
        assert len(seen) >= 2 and seen == [1] * len(seen)
        assert one[:2] == two[:2] and one[3] == two[3] == pairs
    assert not rt.device_extend_wins(total, 4, 1)
    assert rt.device_extend_wins(total, 4, 2)
    assert rt.split_wave(pairs, 4, 1) != rt.split_wave(pairs, 4, 2)


@pytest.mark.parametrize("dev_wins", [True, False])
def test_hybrid_auto_stays_off_where_the_device_chain_wins(rt, monkeypatch,
                                                           tiny_wave,
                                                           dev_wins):
    """PRIBLAST_HYBRID=auto with a card and 4 threads: the whole wave goes
    to the device chain where device_extend_wins says it wins alone, and
    to the hybrid split otherwise. route() only seeds on the host, so a
    cuda device in the list needs no card here."""
    p, chunks, queries = tiny_wave
    monkeypatch.delenv("PRIBLAST_HYBRID", raising=False)
    monkeypatch.setattr(rt, "DEV_DISPATCH_S", 0.0)
    monkeypatch.setattr(rt, "HIT_DENSITY", 0.0)
    monkeypatch.setattr(rt, "HOST_PAIR_RATE", 1e6)
    monkeypatch.setattr(rt, "DEV_PAIR_RATE", 8e6 if dev_wins else 2e6)
    splits = []

    def rec(pairs, threads, n_dev, _fn=rt.split_wave):
        splits.append(_fn(pairs, threads, n_dev))
        return splits[-1]

    monkeypatch.setattr(rt, "split_wave", rec)
    host, dev, _cands, pairs = rt.route(p, chunks, queries, "auto",
                                        [torch.device("cuda", 0)], 4)
    total = sum(pairs.values())
    assert total > 0
    assert rt.device_extend_wins(total, 4, 1) == dev_wins
    if dev_wins:
        assert splits == [] and host == [] and dev == list(pairs)
    else:
        assert splits == [(host, dev)] and host and dev


# ---- ris in each mode against the JAX package in the same mode ----------

def _same_hits(ref: list[str], got: list[str]) -> None:
    assert len(ref) == len(got)
    assert ref[0] == got[0] and ref[2] == got[2]  # headers
    # param header: identical except the db path spelling
    assert ([f for f in ref[1].split(",") if not f.startswith("database:")]
            == [f for f in got[1].split(",") if not f.startswith("database:")])
    for le, lt in zip(ref[3:], got[3:]):
        fe, ft = le.split(","), lt.split(",")
        # id, names, lengths, base pairs: exact
        assert fe[:5] == ft[:5] and fe[8:] == ft[8:], (le, lt)
        for a, b in zip(fe[5:8], ft[5:8]):  # energies: f32 engine noise
            assert abs(float(a) - float(b)) < 2e-3, (le, lt)


def _host_chain(p, idxs, access):
    """The native chain per query on the given accessibilities, formatted
    and numbered as `ris` writes them."""
    names, seqs = fasta.read_fasta(p.input)
    chunks = store.load_chunks(p.db_name, p.hash_size)
    lines = []
    for idx in idxs:
        q_enc = alphabet.encode_query(seqs[idx], p.repeat_flag)
        q_sa = native.sa_build(q_enc)
        q_length = int(np.count_nonzero((q_enc >= 2) & (q_enc <= 5)))
        for chunk in chunks:
            res = native.search_chunk(q_enc, q_sa, *access[idx], chunk, p)
            lines += tris.format_hits(p, res, chunk, names[idx], q_length)
    return [f"{i},{line}" for i, line in enumerate(lines)]


@pytest.mark.parametrize("mode", ["never", "always", "hybrid"])
def test_ris_mode_matches_jax_in_the_same_mode(tmp_path, data_dir,
                                               golden_dir, monkeypatch,
                                               env_rates, mode):
    q_fa, db = str(data_dir / "tiny_q.fa"), str(golden_dir / "tiny" /
                                                 "tiny_db")
    monkeypatch.setitem(ris_gpu._CAL, "host", None)
    monkeypatch.setitem(ris_gpu._CAL, "dev", None)
    monkeypatch.setitem(ris_tpu._CAL, "host", None)
    monkeypatch.setitem(ris_tpu._CAL, "dev", None)
    monkeypatch.setenv("PRIBLAST_DEVICE_EXTEND",
                       {"never": "0", "always": "1", "hybrid": "auto"}[mode])
    splits = []
    if mode == "hybrid":
        # equal rates on both sides and no fixed device cost: the LPT
        # split gives each side some of the three queries
        threads = min(32, os.cpu_count() or 1)
        env_rates(HOST_PAIR_RATE=1e6 / threads, DEV_PAIR_RATE=1e6,
                  DEV_HIT_RATE=1e6, HIT_DENSITY=0, DEV_DISPATCH_S=0)
        monkeypatch.setenv("PRIBLAST_HYBRID", "1")
        split0 = ris_gpu.split_wave

        def split_rec(*a):
            splits.append(split0(*a))
            return splits[-1]

        monkeypatch.setattr(ris_gpu, "split_wave", split_rec)
    access = {}
    access0 = ris_gpu._accessibility_batched

    def access_rec(*a):
        out = access0(*a)
        access.update(out)
        return out

    monkeypatch.setattr(ris_gpu, "_accessibility_batched", access_rec)
    out = tmp_path / "port.txt"
    cli.main(["ris", "-i", q_fa, "-o", str(out), "-d", db, "--device", "cpu"])
    got = out.read_text().splitlines()
    if mode == "hybrid":
        assert len(splits) == 1 and all(splits[0]), splits

    out_jax = str(tmp_path / "tpu.txt")
    jris.run(JRisParams(input=q_fa, output=out_jax, db_name=db,
                        algorithm="block", engine="tpu"))
    _same_hits(open(out_jax).read().splitlines(), got)
    _same_hits((golden_dir / "tiny" / "predictions.txt").read_text()
               .splitlines(), got)
    if mode == "never":
        p = RisParams(input=q_fa, output="-", db_name=db)
        p.load_db_params()
        order = [int(i) for i in native.argsort_desc(
            [len(s) for s in fasta.read_fasta(q_fa)[1]])]
        assert got[3:] == _host_chain(p, order, access)


@pytest.mark.parametrize("mode", ["always", "hybrid"])
def test_a_device_failure_ends_the_run(data_dir, golden_dir, monkeypatch,
                                       mode):
    """The device side raises: run_queries raises it, and the device's
    queries are not searched again on the host (the JAX package redoes
    them there)."""
    from priblast_tpu_torch.search import pipeline

    p = RisParams(input=str(data_dir / "tiny_q.fa"), output="-",
                  db_name=str(golden_dir / "tiny" / "tiny_db"), device="cpu")
    p.load_db_params()
    names, seqs = fasta.read_fasta(p.input)
    chunks = store.load_chunks(p.db_name, p.hash_size)
    order = [int(i) for i in native.argsort_desc([len(s) for s in seqs])]

    def access(_engine, seqs_, _lengths, idxs):
        return {i: native.raccess(alphabet.access_codes(seqs_[i]),
                                  p.maximal_span, p.min_accessible_length)
                for i in idxs}

    def fail(*a, **k):
        raise RuntimeError("device side failed")

    host_calls = []
    search0 = native.search_chunk

    def search_rec(*a, **k):
        if "stage" not in k:
            host_calls.append(a[0].tobytes())
        return search0(*a, **k)

    monkeypatch.setattr(ris_gpu, "_accessibility_batched", access)
    monkeypatch.setattr(pipeline, "search_all", fail)
    monkeypatch.setattr(native, "search_chunk", search_rec)
    if mode == "hybrid":
        monkeypatch.setenv("PRIBLAST_DEVICE_EXTEND", "auto")
        monkeypatch.setenv("PRIBLAST_HYBRID", "1")
        monkeypatch.setattr(ris_gpu, "split_wave",
                            lambda pairs, *a: ([0], sorted(pairs)[1:]))
    else:
        monkeypatch.setenv("PRIBLAST_DEVICE_EXTEND", "1")
    results = [None] * len(seqs)
    with pytest.raises(RuntimeError, match="device side failed"):
        ris_gpu.run_queries(p, chunks, names, seqs, order, results,
                            devices=torch.device("cpu"), threads=2)
    n_host = 1 if mode == "hybrid" else 0
    assert len(host_calls) == n_host * len(chunks)
    if n_host:
        assert host_calls[0] == alphabet.encode_query(
            seqs[order[0]], p.repeat_flag).tobytes()


# ---- stage timers under several threads ----------------------------------

def test_stages_from_several_threads_all_count(monkeypatch):
    monkeypatch.setattr(prof, "_times", type(prof._times)(float))
    monkeypatch.setattr(prof, "_counts", type(prof._counts)(int))
    n_threads, n_stages = 16, 400
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(n_stages):
                with prof.stage(f"side{k % 2}"):
                    pass
                with prof.stage("both"):
                    pass

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert prof.counts() == {"side0": n_threads // 2 * n_stages,
                             "side1": n_threads // 2 * n_stages,
                             "both": n_threads * n_stages}
    assert set(prof.snapshot()) == {"side0", "side1", "both"}
