"""The check's control comes out as not correct: the reference in
bfloat16, the precision below the configurations' float32, put in the
program's place fails a compared number, at a size a test run holds (on
the card, at the cells' own sizes, by `run.py --control`)."""

import pytest

import tiny


@pytest.fixture(autouse=True)
def _device_chain(monkeypatch):
    monkeypatch.setenv("PRIBLAST_DEVICE_EXTEND", "1")


def test_ris_control_fails_the_energy_gap(tmp_path):
    out = tiny.run("ris.tiny", control=True, tmp=str(tmp_path))
    limit = out["compared"]["energy_gap_kcal"]["limit"]
    assert out["correct"] is True
    for form in ("storage", "arithmetic"):
        assert out["control"][form]["energy_gap_kcal"] > limit


def test_db_control_fails_the_accessibility_gap(tmp_path):
    out = tiny.run("db.tiny", control=True, tmp=str(tmp_path))
    assert out["correct"] is True
    assert out["control"]["access_gap_kcal"] > \
        out["compared"]["access_gap_kcal"]["limit"]
