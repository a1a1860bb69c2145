"""The readers of the program's own spans and counters on tiny CPU runs:
each reads a number in its cell where its span or counter ran, and
None where it did not (nothing recorded, or a program that keeps no
counters)."""

from types import SimpleNamespace as NS

import pytest

import tiny
from pbench import spec as specmod

RIS = ("ris_gapped_fetch_s_per_qmnt", "ris_gapped_self_s_per_qmnt",
       "ris_gapped_overflow_share", "ris_gapped_d2h_bytes_per_hit",
       "ris_mid_pool_share", "ris_finish_pool_share")
DB = ("db_read_s_per_mnt", "db_write_s_per_mnt")
COUNTER = ("ris_gapped_overflow_share", "ris_gapped_d2h_bytes_per_hit",
           "ris_mid_pool_share", "ris_finish_pool_share")


@pytest.fixture(autouse=True)
def _device_chain(monkeypatch):
    # the device chain, the cells' path on the card (tests/test_bench_result)
    monkeypatch.setenv("PRIBLAST_DEVICE_EXTEND", "1")


def test_ris_readers_read_the_traced_tiny_run(tmp_path):
    out = tiny.run("ris.tiny", trace=True, tmp=str(tmp_path))
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(RIS) <= set(m)
    assert m["ris_gapped_fetch_s_per_qmnt"] > 0
    assert m["ris_gapped_self_s_per_qmnt"] < m["ris_gapped_s_per_qmnt"]
    assert 0 <= m["ris_gapped_overflow_share"] <= 100
    # int64 [4], float32 [2], int32 [4, max_ext / 2 + 1], bool per hit
    assert m["ris_gapped_d2h_bytes_per_hit"] == 32 + 8 + 16 * 17 + 1
    for k in ("ris_mid_pool_share", "ris_finish_pool_share"):
        assert 0 < m[k] <= 100


def test_db_readers_read_the_traced_tiny_run(tmp_path):
    out = tiny.run("db.tiny", trace=True, tmp=str(tmp_path))
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(DB) <= set(m)
    assert m["db_read_s_per_mnt"] > 0 and m["db_write_s_per_mnt"] > 0
    assert (m["db_read_s_per_mnt"] + m["db_write_s_per_mnt"]
            <= m["db_driver_s_per_mnt"])


@pytest.mark.parametrize("name", RIS + DB)
def test_reader_finds_nothing_where_nothing_ran(name):
    from priblast_tpu_torch.utils import profiling

    profiling.reset()
    run = NS(spans={}, work_nt=1e6, window_s=1.0)
    assert specmod.metric_module(name).read(run) is None


@pytest.mark.parametrize("name", COUNTER)
def test_counter_reader_finds_nothing_without_counters(name, monkeypatch):
    # a program that keeps no counters (the port before it had them)
    from priblast_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    run = NS(spans={"ris.mid.group": 1.0, "ris.finish.group": 1.0},
             work_nt=1e6, window_s=1.0)
    assert specmod.metric_module(name).read(run) is None
