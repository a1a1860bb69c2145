"""The 8-page ris cell's paths at a tiny size on the CPU: a whole run of
a cell whose database is 3 pages of 3 targets (tests/data/
tiny_rna_pages.json), checked `correct` by the reference, its three
readers of the load and the pack reading numbers; and those readers
finding nothing where their spans and counters are absent."""

from types import SimpleNamespace as NS

import pytest

import tiny
from pbench import spec as specmod

CELL = "ris.tiny.pages"
READERS = ("ris_load_s_per_qmnt", "ris_dbpack_s_per_qmnt",
           "ris_dbpack_bytes_per_nt")


def _spec() -> dict:
    """The tiny spec with the multi-page cell (its metrics are the 8-page
    cell's, which benchmark/conftest.py maps to it)."""
    spec = tiny.spec()
    spec["configs"].append(
        {"name": "tiny_rna_pages", "source": "tests", "reduced": ["db_pages"],
         "why": "test", "file": "benchmark/tests/data/tiny_rna_pages.json"})
    spec["workloads"].append({"name": CELL, "config": "tiny_rna_pages",
                              "traffic": "tiny_ris", "chips": 1,
                              "why": "test"})
    return spec


def test_paged_cell_runs_correct_and_reads_the_pack(tmp_path, monkeypatch):
    import torch
    from pbench import main
    from priblast_tpu_torch.utils import profiling

    # the device chain, the cells' path on the card (tests/test_bench_result)
    monkeypatch.setenv("PRIBLAST_DEVICE_EXTEND", "1")
    spec = _spec()
    assert set(READERS) <= {m["name"] for m in specmod.per_layer(spec, CELL)}
    out = main.execute(spec, CELL, 2**31 + 23, 0.5, True,
                       device=torch.device("cpu"), tmp_parent=str(tmp_path),
                       traffic_dir=tiny.DATA)
    assert out["correct"] is True and out["failed"] == 0, out["compared"]
    counters = profiling.counters()
    jobs = counters["ris.waves"]
    assert jobs >= 1 and counters["ris.db_pages"] == 3 * jobs
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["ris_load_s_per_qmnt"] > 0 and m["ris_dbpack_s_per_qmnt"] > 0
    assert m["ris_load_s_per_qmnt"] + m["ris_dbpack_s_per_qmnt"] < \
        m["ris_driver_s_per_qmnt"]
    # int64 sequence, suffix array and four position maps, float32 acc
    # and cond, and the pads and sentinels
    assert 56 < m["ris_dbpack_bytes_per_nt"] < 58


@pytest.mark.parametrize("name", READERS)
def test_pack_readers_find_nothing_where_nothing_ran(name):
    from priblast_tpu_torch.utils import profiling

    profiling.reset()
    run = NS(spans={}, work_nt=1e6, window_s=1.0)
    assert specmod.metric_module(name).read(run) is None


def test_pack_bytes_reader_finds_nothing_without_counters(monkeypatch):
    # a program that keeps no counters (the port before it had them)
    from priblast_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    run = NS(spans={"ris.load": 1.0, "ris.dbpack": 1.0}, work_nt=1e6,
             window_s=1.0)
    assert specmod.metric_module("ris_dbpack_bytes_per_nt").read(run) is None
