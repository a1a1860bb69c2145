"""utils/profiling.py on the CPU: stage intervals (names, parents,
threads, run ids, the bounded buffer), counters, report(), the stage's
own profiler range and the per-command trace of PRIBLAST_TRACE_DIR; then
the spans and counters at their sites on a tiny pipeline run and a tiny
db build."""

import concurrent.futures as cf
import json
import os
import sys
import threading
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

from priblast_tpu_torch.models import db as tdb
from priblast_tpu_torch.search import gapped
from priblast_tpu_torch.search import pipeline as tpl
from priblast_tpu_torch.utils import profiling as prof
from priblast_tpu_torch.utils.params import DbParams
from test_torch_ungapped import build_staged

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh():
    prof.reset()
    yield
    prof.reset()


def _pooled(n=6, threads=3):
    """Stage `outer` on this thread, and inside it `n` stages `outer.group`
    on a pool, each holding a stage `inner`."""
    def one(_):
        with prof.stage("outer.group"):
            with prof.stage("inner"):
                pass
        return threading.get_native_id()

    with prof.stage("outer"):
        with cf.ThreadPoolExecutor(threads) as ex:
            return set(ex.map(one, range(n)))


def test_intervals_name_parent_thread_and_run_across_a_pool():
    with prof.command("ris"):
        pool_tids = _pooled()
    with prof.command("db"):
        with prof.stage("later"):
            pass
    ivs = prof.intervals()
    by = {}
    for iv in ivs:
        by.setdefault(iv.name, []).append(iv)
    main = threading.get_native_id()
    assert [len(by[k]) for k in ("outer", "outer.group", "inner",
                                 "later")] == [1, 6, 6, 1]
    (outer,) = by["outer"]
    assert outer.thread == main and outer.parent is None
    # a pool thread's stage has no parent on its own thread
    assert all(iv.parent is None and iv.thread != main
               for iv in by["outer.group"])
    assert {iv.thread for iv in by["outer.group"]} == pool_tids
    assert all(iv.parent == "outer.group" for iv in by["inner"])
    runs = {iv.run for iv in ivs if iv.name != "later"}
    assert len(runs) == 1 and by["later"][0].run not in runs | {0}
    for iv in ivs:
        assert iv.start <= iv.end
        if iv.name != "later":
            assert outer.start <= iv.start <= iv.end <= outer.end
    assert prof.counts() == {"outer": 1, "outer.group": 6, "inner": 6,
                             "later": 1}
    with prof.stage("outside"):
        pass
    assert prof.intervals()[-1].run == 0


def test_buffer_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(prof, "_intervals", deque(maxlen=3))
    for k in range(5):
        with prof.stage(f"s{k}"):
            pass
    assert [iv.name for iv in prof.intervals()] == ["s2", "s3", "s4"]
    assert prof.counters() == {"profiling.dropped": 2}
    # the sums keep every call
    assert prof.counts() == {f"s{k}": 1 for k in range(5)}


def test_reset_clears_sums_counts_counters_and_intervals():
    with prof.stage("a"):
        pass
    prof.count("c", 3)
    assert prof.snapshot() and prof.counts() and prof.counters()
    assert prof.intervals()
    prof.reset()
    assert (prof.snapshot(), prof.counts(), prof.counters(),
            prof.intervals()) == ({}, {}, {}, [])


@pytest.mark.parametrize("n", [1, 0.25])
def test_counters_under_concurrent_threads(n):
    n_threads, n_adds = 16, 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(n_adds):
                prof.count(f"side{k % 2}", n)
                prof.count("both", n)

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert prof.counters() == {"side0": n_threads // 2 * n_adds * n,
                               "side1": n_threads // 2 * n_adds * n,
                               "both": n_threads * n_adds * n}


def test_report_prints_counters_under_the_stages():
    with prof.stage("ris.gapped"):
        pass
    prof.count("ris.gapped.hits", 1234)
    prof.count("ris.mid.pool_s", 0.5)
    text = prof.report().splitlines()
    assert text[0] == "stage timings:" and "ris.gapped" in text[1]
    assert text[2] == "counters:"
    assert text[3].split() == ["ris.gapped.hits", "1234"]
    assert text[4].split() == ["ris.mid.pool_s", "0.500"]


def _trace_events(path):
    trace = json.loads(path.read_text())
    return trace["traceEvents"], int(trace.get("baseTimeNanoseconds", 0))


@pytest.mark.parametrize("calls", [1, 3])
def test_stage_is_a_range_of_a_recording_profiler(tmp_path, calls):
    # the first range of a process sets the profiler's ops up, ~1.5 ms
    # between the range's start and the stage's clock; later ones ~10 µs
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.profiler.record_function("warm-up"):
            pass
    prof.reset()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        for _ in range(calls):
            with prof.stage("traced.stage"):
                torch.ones(8).sum()
    p.export_chrome_trace(str(tmp_path / "t.json"))
    events, base = _trace_events(tmp_path / "t.json")
    got = sorted((e for e in events if e.get("name") == "traced.stage"),
                 key=lambda e: e["ts"])
    assert len(got) == calls
    assert all(e["cat"] == "user_annotation" for e in got)
    for e, iv in zip(got, prof.intervals()):
        start = float(e["ts"]) * 1e3 + base
        end = start + float(e["dur"]) * 1e3
        assert abs(iv.start - start) < 1e6 and abs(iv.end - end) < 1e6


def test_no_range_and_no_error_with_the_profiler_off(monkeypatch):
    def boom(name):
        raise AssertionError("a range opened with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not torch.autograd._profiler_enabled()
    with prof.stage("quiet"):
        pass
    assert prof.counts() == {"quiet": 1}


@pytest.mark.parametrize("commands", [1, 2])
def test_trace_dir_writes_one_trace_per_command(tmp_path, monkeypatch,
                                                commands):
    monkeypatch.setenv("PRIBLAST_TRACE_DIR", str(tmp_path))
    tids = []
    for _ in range(commands):
        with prof.command("ris"):
            tids.append(_pooled())
    paths = sorted(tmp_path.glob("ris_*.json"),
                   key=lambda f: int(f.stem.rsplit("_", 1)[1]))
    assert len(paths) == commands
    main = threading.get_native_id()
    for path, pool_tids in zip(paths, tids):
        events, _ = _trace_events(path)
        names = [(e["name"], e["tid"]) for e in events
                 if e.get("cat") == "user_annotation"]
        # the calling thread's stage once (its own range), the pool's
        # stages as events of their own threads
        assert names.count(("outer", main)) == 1
        assert sorted(n for n, tid in names if tid in pool_tids) == \
            ["inner"] * 6 + ["outer.group"] * 6
        assert {tid for n, tid in names if n == "outer.group"} == pool_tids


def test_pool_threads_with_cuda_events_still_get_their_stages(tmp_path):
    """A thread that only launched CUDA work has runtime events under its
    own tid, and a device event's tid is a stream id; neither makes its
    stages count as recorded."""
    with prof.command("ris"):
        pool_tids = _pooled()
    (run,) = {iv.run for iv in prof.intervals()}
    main = threading.get_native_id()
    pid = os.getpid()
    events = [{"ph": "X", "cat": "user_annotation", "name": "outer",
               "pid": pid, "tid": main, "ts": 0, "dur": 1}]
    for tid in pool_tids:
        events += [{"ph": "X", "cat": "cuda_runtime",
                    "name": "cudaLaunchKernel", "pid": pid, "tid": tid,
                    "ts": 0, "dur": 1},
                   {"ph": "X", "cat": "kernel", "name": "k", "pid": 0,
                    "tid": tid, "ts": 0, "dur": 1}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events,
                                "baseTimeNanoseconds": 0}))
    prof._add_unseen_threads(str(path), run)
    got, _ = _trace_events(path)
    names = [(e["name"], e["tid"]) for e in got
             if e.get("cat") == "user_annotation"]
    assert names.count(("outer", main)) == 1
    assert sorted(n for n, tid in names if tid in pool_tids) == \
        ["inner"] * 6 + ["outer.group"] * 6


def test_trace_dir_opens_no_profiler_inside_a_recording_one(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("PRIBLAST_TRACE_DIR", str(tmp_path / "traces"))
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with prof.command("db"):
            with prof.stage("db.read"):
                pass
    p.export_chrome_trace(str(tmp_path / "outer.json"))
    assert not (tmp_path / "traces").exists()
    events, _ = _trace_events(tmp_path / "outer.json")
    assert [e["name"] for e in events].count("db.read") == 1


# ---- the spans and counters at their sites --------------------------------

@pytest.fixture(scope="module")
def staged(tmp_path_factory, data_dir):
    return build_staged(tmp_path_factory.mktemp("torch_profiling"), data_dir)


@pytest.mark.parametrize("max_ext,threads", [(32, 1), (8, 3)])
def test_search_sites_count_hits_overflow_and_groups(staged, monkeypatch,
                                                     max_ext, threads):
    chunks, p, queries, qpack, dbpack, _pres, _posts = staged
    flagged = []
    orig = gapped.gapped_extend_flat_batch

    def spy(*a, **k):
        out = orig(*a, **k)
        flagged.append(int(out[2].sum()))
        return out

    monkeypatch.setattr(gapped, "gapped_extend_flat_batch", spy)
    stream = tpl.seed_stage(p, chunks, queries, threads)
    pairs = len(stream.groups)
    tpl._hit_bases(stream, qpack, dbpack)
    tpl.ungapped_stage(stream, qpack, dbpack, p, device=CPU)
    stream = tpl.threshold_stage(stream, p)
    stream, _ = tpl.finish_search(stream, p, chunks, queries, qpack, dbpack,
                                  devices=CPU, threads=threads,
                                  dtype="float64", max_ext=max_ext)
    c, n, spans = prof.counters(), prof.counts(), prof.snapshot()
    assert c["ris.gapped.hits"] == len(stream) > 0
    assert c["ris.gapped.overflow"] == sum(flagged)
    if max_ext == 8:
        assert sum(flagged) > 0
    T = max_ext // 2 + 1
    # int64 [4] + float64 [2] + int32 [4, T] + bool per hit
    assert c["ris.gapped.d2h_bytes"] == len(stream) * (32 + 16 + 16 * T + 1)
    assert n["ris.gapped.fetch"] == len(flagged)
    assert spans["ris.gapped.fetch"] <= spans["ris.gapped"]
    for st in ("ris.mid", "ris.finish"):
        assert n[f"{st}.group"] == len(stream.groups)
        assert 0 < spans[f"{st}.group"] <= c[f"{st}.pool_s"]
    # the seed stage maps its pairs with no span or counter of its own
    assert pairs > 0 and "ris.seed.group" not in n
    assert "ris.seed.pool_s" not in c


def test_db_build_reads_and_writes_once(tmp_path, data_dir):
    for k in range(2):
        tdb.run(DbParams(input=str(data_dir / "tiny_db.fa"),
                         db_name=str(tmp_path / f"db{k}"),
                         algorithm="block", engine="exact"))
        n = prof.counts()
        assert (n["db.read"], n["db.write"]) == (k + 1, k + 1)
    runs = {iv.name: iv.run for iv in prof.intervals()
            if iv.name in ("db.read", "db.write")}
    assert set(runs) == {"db.read", "db.write"} and 0 not in runs.values()


def test_db_build_under_trace_dir_carries_its_stages(tmp_path, data_dir,
                                                     monkeypatch):
    monkeypatch.setenv("PRIBLAST_TRACE_DIR", str(tmp_path / "traces"))
    tdb.run(DbParams(input=str(data_dir / "tiny_db.fa"),
                     db_name=str(tmp_path / "db"), algorithm="block",
                     engine="exact"))
    (path,) = (tmp_path / "traces").glob("db_*.json")
    names = [e["name"] for e in _trace_events(path)[0]
             if e.get("cat") == "user_annotation"]
    for st in ("db.read", "db.accessibility", "db.index", "db.write"):
        assert names.count(st) == 1, st
    assert np.all([iv.run > 0 for iv in prof.intervals()])
