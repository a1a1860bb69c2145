"""The accessibility kernels' work, counted from the inputs: the bytes
each must move and the operations it must do for one sequence of N
nucleotides (N + 1 columns) at the maximal span W (band W + 2), and the
least time the card could take for them at its published peaks.

The arithmetic of each count is a frozen copy of the repository's
chip_smoke.py functions (`access_ops_per_column`, `access_bound_ms`,
`prob_ops_per_row`, `prob_bound_ms`, `grids_bound_ms`), re-based from a
padded batch (B rows of the batch's longest length) to one sequence at
its own length: a batch's padding is work the inputs do not need, so it
shows as share lost against the bound."""

from __future__ import annotations

import functools

import numpy as np

# NVIDIA H100 SXM, data sheet, dense rates, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
ML = 30  # the longest interior loop (thermo MAXLOOP)


def access_ops_per_column(band: int, ml: int, c: int, inside: bool) -> int:
    """Operations of one column of one sequence of an accessibility scan,
    with c columns before it (inside) or after it (outside): 2 per
    multiply-add, 1 per add (chip_smoke.py:access_ops_per_column)."""
    W = band - 2
    r = np.arange(2, ml + 1)
    d = np.arange(band)
    ops = 2 * int(((np.minimum(r, c) + 1) * (band - r)).sum())
    ops += int((band - r).sum())
    room = d if inside else band - 1 - d
    ops += 2 * int(np.maximum(np.minimum(ml, room) - 1, 0).sum())
    ops += 2 * int(np.maximum(np.minimum(np.minimum(ml, room), c) - 1,
                              0).sum())
    ops += band
    if inside:
        ops += 2 * int(np.minimum(np.minimum(W, d), c).sum())
        ops += 2 * int((d + 1).sum())
        ops += 2 * 5 * min(band - 1, c)
        ops += 28 * band
    else:
        ops += 2 * int((band - d).sum())
        ops += 2 * int(np.minimum(np.minimum(W, band - 1 - d), c).sum())
        ops += 2 * int(np.maximum(W - d, 0).sum())
        ops += 31 * band
    return ops


@functools.lru_cache(maxsize=None)
def _column_ops(band: int, inside: bool):
    """access_ops_per_column for c = 0 .. band (a column with band or
    more columns on its side costs what one with band does)."""
    return tuple(access_ops_per_column(band, ML, c, inside)
                 for c in range(band + 1))


def scan_work(n1: int, band: int, item: int, inside: bool):
    """(bytes, operations) of one column scan over one sequence of n1
    columns (chip_smoke.py:access_bound_ms at B = 1)."""
    R = ML + 1
    cells = n1 * band
    nbytes = cells * (21 * item + 2) + (2 * n1 * item if inside else 0)
    nbytes += (R * R + R + band) * item
    full = max(n1 - band, 0)
    per = _column_ops(band, inside)
    ops = sum(per[: n1 - full]) + full * per[band]
    return nbytes, ops


def prob_ops_per_row(n1: int, band: int, w: int, ml: int) -> int:
    """Operations of the probability pass for one sequence over n1
    columns (chip_smoke.py:prob_ops_per_row)."""
    N, W = n1 - 1, band - 2
    c = np.arange(n1)
    ops = np.zeros(n1, np.int64)
    for u in range(w, ml + 1):
        e = np.arange(u + 1, band)
        per = 2 * np.minimum(ml - u, e - u) + 2
        cum = np.concatenate([[0], np.cumsum(per)])
        ops += np.where(c >= u, int(per.sum()), 0)
        ops += cum[np.clip(N - c - u, 0, len(e))]
        if u >= 2:
            nb = band - u
            ops += np.where(c >= u, 2 * nb + 2, 0)
            ops += 2 * np.clip(N - c - u + 1, 0, nb) + 2
    for u1, u2 in ((1, 0), (0, 1), (1, 1), (1, 2), (2, 1), (2, 2)):
        spans = band - u1 - u2
        if u2 >= w:
            ops += np.where(c >= u2, 3 * spans + 1, 0)
        if u1 >= w:
            ops += 3 * np.clip(N - c - u1 - u2 + 1, 0, spans) + 1
    nu = max(ml - w + 1, 0)
    nt = max(nu - 1, 0)
    ops += band + sum(band - o for o in range(w, band - 1))
    ops += nt * (nt + 1) + nu
    x = c
    for wsz in (w, w + 1):
        ops += 3 + 2 * np.clip(N - x + 1 - wsz + 1, 0, max(band - wsz, 0))
        ops += np.where((x >= 1) & (x + wsz - 1 <= N),
                        2 * max(W - wsz + 1, 0), 0) + 1
    ops += np.clip(N - x + 2 - w, 0, max(band - 1 - w, 0)) * 2
    ops += np.minimum(x, nu) + 1 + 2 * nt + 8
    return int(ops.sum())


# past this many columns a row's probability-pass operations grow by the
# same count per column (every term is a constant or a clipped linear
# function of the columns before or after it, all clips reached)
_AFFINE_FROM = 4 * (72 + ML)


@functools.lru_cache(maxsize=None)
def prob_ops(n1: int, band: int, w: int) -> int:
    """prob_ops_per_row, the long rows by their exact affine growth."""
    n0 = max(_AFFINE_FROM, 2 * (band + ML))
    if n1 <= n0 + 1:
        return prob_ops_per_row(n1, band, w, ML)
    a, b = prob_ops(n0, band, w), prob_ops(n0 + 1, band, w)
    return a + (n1 - n0) * (b - a)


def prob_work(n1: int, band: int, w: int, item: int):
    """(bytes, operations) of the probability pass over one sequence
    (chip_smoke.py:prob_bound_ms at B = 1)."""
    R = ML + 1
    planes = 10 + (w <= 2)
    nbytes = (planes * n1 * band + 2 * n1 + 1 + 2 * (n1 + 1)) * item
    nbytes += (R * R + R) * item
    if w <= 2:
        nbytes += (n1 + ML + 3) * 8 + 4 * (49 + 8 * 8 * (25 + 125 + 625))
    return nbytes, prob_ops(n1, band, w)


def grids_work(n1: int, band: int, S: int, item: int, inside: bool):
    """(bytes, operations) of one weight-grid launch over one sequence
    (chip_smoke.py:grids_bound_ms at B = 1; S codes read)."""
    cells = n1 * band
    tables = 2 * 25 + 49 + 2 * 175 + 8 * 8 * (25 + 125 + 625) + 2 * 35 + 7
    nbytes = S * 8 + 8 + 4 * (tables + 2 * band)
    if inside:
        nbytes += cells * (15 * item + 2)
        ops = 14 * cells
    else:
        nbytes += cells * (15 * item + 2) + (2 * n1 + 1) * item
        ops = 17 * cells
    return nbytes, ops


KERNELS = ("grids_inside", "grids_outside", "scan_inside", "scan_outside",
           "prob")


def access_work(lengths, w_span: int, w: int, dtype: str = "float32"):
    """Per kernel, (bytes, operations) summed over sequences of the given
    lengths, each at its own length."""
    item = 8 if dtype == "float64" else 4
    band = w_span + 2
    tot = {k: [0, 0] for k in KERNELS}
    for n, count in zip(*np.unique(np.asarray(lengths, np.int64),
                                   return_counts=True)):
        n1 = int(n) + 1
        parts = {
            "grids_inside": grids_work(n1, band, n1, item, True),
            "grids_outside": grids_work(n1, band, n1, item, False),
            "scan_inside": scan_work(n1, band, item, True),
            "scan_outside": scan_work(n1, band, item, False),
            "prob": prob_work(n1, band, w, item),
        }
        for k, (b, o) in parts.items():
            tot[k][0] += int(count) * b
            tot[k][1] += int(count) * o
    return {k: tuple(v) for k, v in tot.items()}


def least_seconds(work: dict, dtype: str = "float32"):
    """Per kernel, (least seconds, "bytes" or "operations") at the peaks."""
    out = {}
    for k, (b, o) in work.items():
        tb, to = b / HBM_BYTES_PER_S, o / PEAK_FLOPS[dtype]
        out[k] = (max(tb, to), "bytes" if tb >= to else "operations")
    return out
