"""The port's ris host/device router (models/ris_gpu.py) against the JAX
package's (priblast_tpu/models/ris_tpu.py): the cases of
tests/test_router.py on the port's module, device_extend_wins on the same
seeded inputs with both modules' constants set alike (their default rates
differ on purpose: the port's are measured on its own card), and `ris
--device cpu` in each mode of PRIBLAST_DEVICE_EXTEND against the JAX
package's `--engine tpu` run in the same mode. Also: a failure of the
device chain ends the run, and the stage timers count stages from several
threads."""

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


# ---- the cases of tests/test_router.py on the port's router --------------

def test_env_rates_flip_the_router(monkeypatch):
    """A platform whose device rates are 100x another's flips the
    winner-take-all estimate through the router's rate constants alone."""
    n_pairs, threads = 10_000_000, 2
    slow = dict(HOST_PAIR_RATE=2e5, DEV_PAIR_RATE=1e6, DEV_HIT_RATE=1e4,
                HIT_DENSITY=0.1, DEV_DISPATCH_S=0.1)
    for name, value in slow.items():
        monkeypatch.setattr(ris_gpu, name, value)
    assert not ris_gpu.device_extend_wins(n_pairs, threads, 1)
    monkeypatch.setattr(ris_gpu, "DEV_PAIR_RATE", 100 * slow["DEV_PAIR_RATE"])
    monkeypatch.setattr(ris_gpu, "DEV_HIT_RATE", 100 * slow["DEV_HIT_RATE"])
    assert ris_gpu.device_extend_wins(n_pairs, threads, 1)


# ---- parity with the JAX package's router --------------------------------

@pytest.mark.parametrize("n_dev", [1, 2, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_and_choice_match_the_jax_router(monkeypatch, seed, n_dev):
    """The winner-take-all choice of both routers on the same rates, with
    the device count entering as the JAX package's mesh size does
    (ris_tpu.py:216): 1, 2 and 8 devices."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        rates = dict(HOST_PAIR_RATE=float(rng.uniform(1e4, 1e6)),
                     DEV_PAIR_RATE=float(rng.uniform(1e5, 1e8)),
                     DEV_HIT_RATE=float(rng.uniform(1e3, 1e6)),
                     HIT_DENSITY=float(rng.uniform(0.0, 0.3)),
                     DEV_DISPATCH_S=float(rng.uniform(0.0, 0.5)))
        for mod in (ris_gpu, ris_tpu):
            for name, value in rates.items():
                monkeypatch.setattr(mod, name, value)
        threads = int(rng.integers(1, 33))
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


def test_route_counts_a_repeated_device_once(monkeypatch, tiny_wave):
    """route() with devices=[cpu, cpu] (two shards on one device) chooses
    as with [cpu]: the rate counts distinct devices, as the JAX package's
    mesh does. The rates make the device side's width decide."""
    p, chunks, queries = tiny_wave
    seen = []

    def rec(pairs, threads, n_dev, _fn=ris_gpu.device_extend_wins):
        seen.append(n_dev)
        return _fn(pairs, threads, n_dev)

    monkeypatch.setattr(ris_gpu, "device_extend_wins", rec)
    pairs = ris_gpu.route(p, chunks, queries, "auto", [CPU], 4)[3]
    total = sum(pairs.values())
    assert total > 0
    # the device side, at one device, a little slower than the host's 4
    # threads, so that a second device would flip the choice
    monkeypatch.setattr(ris_gpu, "DEV_DISPATCH_S", 0.0)
    monkeypatch.setattr(ris_gpu, "HIT_DENSITY", 0.0)
    monkeypatch.setattr(ris_gpu, "HOST_PAIR_RATE", 1e6)
    monkeypatch.setattr(ris_gpu, "DEV_PAIR_RATE", 3.5e6)
    seen.clear()
    one = ris_gpu.route(p, chunks, queries, "auto", [CPU], 4)
    two = ris_gpu.route(p, chunks, queries, "auto", [CPU, CPU], 4)
    assert seen == [1, 1]
    assert one[:2] == two[:2] == (list(pairs), [])
    assert one[3] == two[3] == pairs
    assert not rec(total, 4, 1) and rec(total, 4, 2)


@pytest.mark.parametrize("dev_wins", [True, False])
def test_auto_sends_the_whole_wave_to_the_winning_chain(monkeypatch,
                                                       tiny_wave, dev_wins):
    """In auto with a card and 4 threads the whole wave goes to the chain
    device_extend_wins picks, with the seed candidates where that is the
    device chain. route() only seeds on the host, so a cuda device in the
    list needs no card here."""
    p, chunks, queries = tiny_wave
    monkeypatch.setattr(ris_gpu, "DEV_DISPATCH_S", 0.0)
    monkeypatch.setattr(ris_gpu, "HIT_DENSITY", 0.0)
    monkeypatch.setattr(ris_gpu, "HOST_PAIR_RATE", 1e6)
    monkeypatch.setattr(ris_gpu, "DEV_PAIR_RATE", 8e6 if dev_wins else 2e6)
    host, dev, cands, pairs = ris_gpu.route(p, chunks, queries, "auto",
                                            [torch.device("cuda", 0)], 4)
    total = sum(pairs.values())
    assert total > 0 and cands
    assert ris_gpu.device_extend_wins(total, 4, 1) == dev_wins
    every = list(range(len(queries)))
    assert (host, dev) == (([], every) if dev_wins else (every, []))


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


@pytest.mark.parametrize("mode", ["never", "always", "auto"])
def test_ris_mode_matches_jax_in_the_same_mode(tmp_path, data_dir,
                                               golden_dir, monkeypatch,
                                               mode):
    q_fa, db = str(data_dir / "tiny_q.fa"), str(golden_dir / "tiny" /
                                                 "tiny_db")
    monkeypatch.setenv("PRIBLAST_DEVICE_EXTEND",
                       {"never": "0", "always": "1", "auto": "auto"}[mode])
    routes = []
    route0 = ris_gpu.route

    def route_rec(*a):
        routes.append((a[5], route0(*a)))   # threads, the route
        return routes[-1][1]

    monkeypatch.setattr(ris_gpu, "route", route_rec)
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
    # one wave, all on one chain; in auto, the one device_extend_wins picks
    ((threads, (host, dev, cands, pairs)),) = routes
    assert not (host and dev)
    if mode == "auto":
        wins = ris_gpu.device_extend_wins(sum(pairs.values()), threads, 1)
        assert cands and bool(dev) == wins

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


@pytest.mark.parametrize("mode", ["always", "auto"])
def test_a_device_failure_ends_the_run(data_dir, golden_dir, monkeypatch,
                                       mode):
    """The device chain raises: run_queries raises it, and the wave's
    queries are not searched again on the host (the JAX package redoes
    them there), in either mode that sends the wave to the device."""
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
    if mode == "auto":
        monkeypatch.setenv("PRIBLAST_DEVICE_EXTEND", "auto")
        monkeypatch.setattr(ris_gpu, "device_extend_wins", lambda *a: True)
    else:
        monkeypatch.setenv("PRIBLAST_DEVICE_EXTEND", "1")
    results = [None] * len(seqs)
    with pytest.raises(RuntimeError, match="device side failed"):
        ris_gpu.run_queries(p, chunks, names, seqs, order, results,
                            devices=torch.device("cpu"), threads=2)
    assert host_calls == []


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
