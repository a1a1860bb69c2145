"""The frozen work counts (pbench/counts.py): a hand count on a tiny
shape, the originals of chip_smoke.py at one sequence, and the long rows'
affine growth."""

import sys
from pathlib import Path

import pytest

from pbench import counts

ROOT = Path(__file__).resolve().parents[2]


def test_column_ops_by_hand():
    # band 4 (W 2), loops up to 2, the first column of the inside scan:
    # contraction 2*(1*2) + 2, bulges 2*(0+0+1+1), + band 4, multi sum
    # 2*(1+2+3+4), element-wise 28*4
    assert counts.access_ops_per_column(4, 2, 0, True) == \
        4 + 2 + 4 + 4 + 20 + 112


def test_grids_by_hand():
    # 3 columns x band 4 = 12 cells; codes 3 x 8 B, lengths 8 B, tables
    # 50,126 and 2 band rows of 4 B, 15 planes of 4 B + 2 bool planes
    tables = 2 * 25 + 49 + 2 * 175 + 8 * 8 * (25 + 125 + 625) + 2 * 35 + 7
    assert counts.grids_work(3, 4, 3, 4, True) == (
        24 + 8 + 4 * (tables + 8) + 12 * 62, 14 * 12)
    assert counts.grids_work(3, 4, 3, 4, False)[1] == 17 * 12


def test_scan_sums_columns():
    band = 6
    n1 = 20
    by_col = sum(counts.access_ops_per_column(band, counts.ML, min(c, band),
                                              False) for c in range(n1))
    assert counts.scan_work(n1, band, 4, False)[1] == by_col


@pytest.mark.parametrize("n1", [201, 300, 409, 410, 777, 2001])
def test_prob_ops_affine_growth_is_exact(n1):
    assert counts.prob_ops(n1, 72, 5) == \
        counts.prob_ops_per_row(n1, 72, 5, counts.ML)


@pytest.mark.parametrize("n", [150, 800, 3000])
def test_same_as_chip_smoke_at_one_sequence(n):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    n1 = n + 1
    got = counts.least_seconds(counts.access_work([n], 70, 5))
    ref = {
        "scan_inside": cs.access_bound_ms(1, n1, 72, 4, True),
        "scan_outside": cs.access_bound_ms(1, n1, 72, 4, False),
        "prob": cs.prob_bound_ms(1, n1, 72, 5, 4),
        "grids_inside": cs.grids_bound_ms(1, n1, 72, n1, 4, True),
        "grids_outside": cs.grids_bound_ms(1, n1, 72, n1, 4, False),
    }
    for k, (ms, by) in ref.items():
        assert got[k][1] == by
        assert got[k][0] * 1e3 == pytest.approx(ms, rel=1e-12)


def test_padding_is_not_counted():
    """A batch's bound counts its padded rows; the cell's counts the
    sequences' own lengths only."""
    lens = [300, 1000]
    w = counts.access_work(lens, 70, 5)
    w2 = counts.access_work([1000, 1000], 70, 5)
    assert w["scan_inside"][1] < w2["scan_inside"][1]
    one = counts.access_work([300], 70, 5)
    two = counts.access_work([1000], 70, 5)
    assert w["prob"][1] == one["prob"][1] + two["prob"][1]
