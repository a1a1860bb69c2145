"""Bit-exact vectorized replicas of the table-driven fast exp/log
approximations used by the reference (herumi/fmath; reference:
src/fmath.hpp:400-470 `expd`, :738-752 `log`).

The reference's accessibility energies flow through these approximations
rather than libm, so exact predictions.txt parity requires replicating them
including all intermediate roundings. Both functions are deterministic pure
table lookups + IEEE arithmetic, reproduced here in numpy (`expd`, `logf`,
`logsumexp2`) and in PyTorch (`expd_torch`, `logf_torch`,
`logsumexp2_torch`, on any device), bit for bit alike.

The tables were precomputed with the same libm the reference uses at
static-init time and are stored in priblast_tpu_torch/data/fmath_tables.npz.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

_DATA = Path(__file__).resolve().parent.parent / "data" / "fmath_tables.npz"

_EXPD_SBIT = 11
_EXPD_MASK = (1 << _EXPD_SBIT) - 1
_EXPD_ADJ = (1 << (_EXPD_SBIT + 10)) - (1 << _EXPD_SBIT)
_EXPD_B = float(np.uint64(3) << np.uint64(51))  # 3 * 2^51
_EXPD_C1 = 1.0
_EXPD_C2 = 0.16666666685227835064
_EXPD_C3 = 3.0000000027955394
_EXPD_MIN = -708.39641853226408  # expd(x) == 0 below this
_EXPD_MAX = 709.78271289338397  # expd(x) == inf above this
_EXPD_A = 2048.0 / np.log(2.0)

_LOG_LEN = 11
_LOG_MASK_B2 = (1 << (23 - _LOG_LEN)) - 1


@functools.lru_cache(maxsize=1)
def _tables():
    with np.load(_DATA) as z:
        return (
            z["expd_tbl"].copy(),  # (2048,) uint64: low 52 bits of 2^(i/2048)
            z["log_app"].copy(),  # (2048,) float32
            z["log_rev"].copy(),  # (2048,) float32
            np.float32(z["c_log2"]),
        )


def expd(x: np.ndarray) -> np.ndarray:
    """fmath::expd — double-precision exp with an 11-bit 2^frac table and a
    cubic correction polynomial. Vectorized, bit-exact vs the reference."""
    tbl, _, _, _ = _tables()
    x = np.asarray(x, dtype=np.float64)
    ra = 1.0 / _EXPD_A

    d = x * _EXPD_A + _EXPD_B
    bits = d.view(np.uint64)
    # Low 32 bits of the double's pattern, sign-extended (the reference reads
    # them via _mm_cvtsi128_si32 into a uint64_t).
    di32 = (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    di = di32.astype(np.int64).view(np.uint64)
    iax = tbl[(di & np.uint64(_EXPD_MASK)).astype(np.int64)]
    t = (d - _EXPD_B) * ra - x
    u = ((di + np.uint64(_EXPD_ADJ)) >> np.uint64(_EXPD_SBIT)) << np.uint64(52)
    y = (_EXPD_C3 - t) * (t * t) * _EXPD_C2 - t + _EXPD_C1
    res = y * (u | iax).view(np.float64)
    res = np.where(x <= _EXPD_MIN, 0.0, res)
    res = np.where(x >= _EXPD_MAX, np.inf, res)
    return res


def logf(x: np.ndarray) -> np.ndarray:
    """fmath::log — single-precision log via an 11-bit mantissa table.
    Vectorized, bit-exact vs the reference. Returns float32."""
    _, app, rev, c_log2 = _tables()
    x = np.asarray(x, dtype=np.float32)
    i = x.view(np.uint32)
    a = (i & np.uint32(0xFF << 23)).astype(np.int32)  # exponent field
    b2 = (i & np.uint32(_LOG_MASK_B2)).astype(np.int32)
    idx = ((i >> np.uint32(23 - _LOG_LEN))
           & np.uint32((1 << _LOG_LEN) - 1)).astype(np.int64)
    t1 = (a - (127 << 23)).astype(np.float32) * c_log2
    t2 = b2.astype(np.float32) * rev[idx]
    return (t1 + app[idx]) + t2


def logsumexp2(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The reference's pairwise log-add (src/raccess.cpp:414-419):
    max(x,y) + log(expd(-|x-y|) + 1), with log computed in float32."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    gt = x > y
    hi = np.where(gt, x, y)
    lo = np.where(gt, y, x)
    return hi + logf((expd(lo - hi) + 1.0).astype(np.float32)).astype(
        np.float64)


# ---------------------------------------------------------------------------
# PyTorch replicas: the same tables and bit manipulations, in signed
# integers (a left shift keeps the low 64 bits and a right shift's sign
# bits are masked or shifted out, so the bits equal the unsigned ones).
# ---------------------------------------------------------------------------

_torch_tables_cache: dict = {}


def _torch_tables(device):
    import torch

    key = str(device)
    if key not in _torch_tables_cache:
        tbl, app, rev, c_log2 = _tables()
        _torch_tables_cache[key] = (
            torch.as_tensor(tbl.view(np.int64), device=device),
            torch.as_tensor(app, device=device),
            torch.as_tensor(rev, device=device),
            float(c_log2))
    return _torch_tables_cache[key]


def expd_torch(x):
    """PyTorch replica of :func:`expd` (float64 in and out)."""
    import torch

    x = torch.as_tensor(x, dtype=torch.float64)
    tbl, _, _, _ = _torch_tables(x.device)
    ra = 1.0 / _EXPD_A
    d = x * _EXPD_A + _EXPD_B
    bits = d.view(torch.int64)
    # the low 32 bits, sign-extended
    di = ((bits & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    iax = tbl[di & _EXPD_MASK]
    t = (d - _EXPD_B) * ra - x
    u = (((di + _EXPD_ADJ) >> _EXPD_SBIT) & 0xFFF) << 52
    y = (_EXPD_C3 - t) * (t * t) * _EXPD_C2 - t + _EXPD_C1
    res = y * (u | iax).view(torch.float64)
    res = torch.where(x <= _EXPD_MIN, 0.0, res)
    return torch.where(x >= _EXPD_MAX, float("inf"), res)


def logf_torch(x):
    """PyTorch replica of :func:`logf`. Returns float32."""
    import torch

    x = torch.as_tensor(x, dtype=torch.float32)
    _, app, rev, c_log2 = _torch_tables(x.device)
    i = x.view(torch.int32)
    a = i & (0xFF << 23)
    b2 = i & _LOG_MASK_B2
    idx = ((i >> (23 - _LOG_LEN)) & ((1 << _LOG_LEN) - 1)).long()
    t1 = (a - (127 << 23)).to(torch.float32) * torch.tensor(
        c_log2, dtype=torch.float32, device=x.device)
    t2 = b2.to(torch.float32) * rev[idx]
    return (t1 + app[idx]) + t2


def logsumexp2_torch(x, y):
    """PyTorch replica of :func:`logsumexp2` (float64 in and out)."""
    import torch

    x = torch.as_tensor(x, dtype=torch.float64)
    y = torch.as_tensor(y, dtype=torch.float64)
    gt = x > y
    hi = torch.where(gt, x, y)
    lo = torch.where(gt, y, x)
    return hi + logf_torch((expd_torch(lo - hi) + 1.0).to(
        torch.float32)).to(torch.float64)
