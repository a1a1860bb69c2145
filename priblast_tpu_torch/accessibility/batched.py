"""Batched accessibility engine (PyTorch).

Computes per-window accessibilities for a *batch* of padded sequences with
the linear-domain scaled formulation of accessibility/linear_ref.py (banded
cells ``[column j][span d]`` scaled by sigma^-d, exterior arrays in log
space; reference recurrences: src/raccess.cpp:99-771).

Layout: every per-column weight grid and every stacked state is
``[N+1, B, band]`` (column j leading). The passes:

- ``make_grids`` / ``make_outside_grids`` / ``make_prob_grids``: all
  sequence- and pair-type-dependent weights, as direct table gathers
  ``tab[index(chars around i, chars around j)]`` over the whole grid. On
  ``cuda`` the first two run as a hand-written kernel, a thread per cell
  (ops/access_grids.py); the functions here are its plain versions;
- ``inside_pass`` / ``outside_pass`` / ``b_outer_scan``: the column scans.
  On ``cuda`` they run as two hand-written kernels (ops/access_scan.py:
  the inside pass with both exterior scans, and the outside pass; one CTA
  per sequence, the carry in shared memory). The functions here are those
  kernels' plain versions, which the CPU runs: one Python loop step per
  column over ``[B, band]`` tensors, carrying small rolling windows; the
  31x31 interior-loop kernel is an einsum and the multiloop span
  accumulation a triangular matmul;
- ``probability_pass``: window probabilities, vectorized over the grid.
  On ``cuda`` it runs, with ``make_prob_grids`` and the sum of its terms
  (``scan_probabilities``) and the window energies
  (``accessibility_from_probabilities``), as a hand-written kernel
  (ops/access_prob.py: the energies written by its last launch); the
  functions here are its plain version.

Every table value that the formulation rounds to float32 is rounded here
at the same place, so float64 runs agree with the float32-table semantics
of the reference formulation to float64 rounding noise.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from priblast_tpu_torch.accessibility.linear_ref import LinearModel
from priblast_tpu_torch.parallel import dist
from priblast_tpu_torch.utils import thermo

TURN = thermo.TURN
ML = thermo.MAXLOOP

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@functools.lru_cache(maxsize=8)
def _linmodel(w_span: int, log_sigma: float = 1.0) -> LinearModel:
    return LinearModel(w_span, log_sigma)


def _npdt(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


class Tables(NamedTuple):
    """Device constant tables of the scans."""
    bp: torch.Tensor          # (5,5) int32
    rtype: torch.Tensor       # (7,) int32
    W_stack: torch.Tensor     # (7,7)
    W_int11: torch.Tensor
    W_int21: torch.Tensor
    W_int22: torch.Tensor
    W_mism_i: torch.Tensor
    W_mism_h: torch.Tensor
    W_d5: torch.Tensor
    W_d3: torch.Tensor
    W_au: torch.Tensor        # (7,)
    W_hairpin_len: torch.Tensor
    W_bulge_len: torch.Tensor
    K2: torch.Tensor          # (ML+1, ML+1): K2[r, u2] = K_int[r-u2, u2]
    Kb: torch.Tensor          # (ML+1,) bulge kernel (u >= 2)
    Lmat: torch.Tensor        # (band, band) triangular decay matmul for multi
    KbMat: torch.Tensor       # (band, band) banded bulge conv matmul
    sig_pow: torch.Tensor
    inv_sig_pow: torch.Tensor
    W_mlb: float
    W_mli: float
    W_mlc: float
    lsig: float
    kT: float


_INT_FIELDS = ("bp", "rtype")
_SCALAR_FIELDS = ("W_mlb", "W_mli", "W_mlc", "lsig", "kT")


def tables_from_numpy(fields: dict, dtype=torch.float32,
                      device="cpu") -> Tables:
    """Build Tables from numpy arrays (one entry per field name): integer
    tables as int32, float tables in `dtype`, scalars as Python floats."""
    out = {}
    for name in Tables._fields:
        v = fields[name]
        if name in _SCALAR_FIELDS:
            out[name] = float(v)
        elif name in _INT_FIELDS:
            out[name] = torch.tensor(np.asarray(v, np.int32), device=device)
        else:
            out[name] = torch.tensor(np.asarray(v, np.float64), dtype=dtype,
                                     device=device)
    return Tables(**out)


def make_tables(w_span: int, dtype=torch.float32, device="cpu",
                log_sigma: float = 1.0) -> Tables:
    m = _linmodel(w_span, log_sigma)
    band = w_span + 2

    K2 = np.zeros((ML + 1, ML + 1))
    for r in range(ML + 1):
        for u2 in range(ML + 1):
            if 0 <= r - u2 <= ML:
                K2[r, u2] = m.K_int[r - u2, u2]

    decay = float(m.W_mlb * np.exp(-m.lsig))
    t_idx = np.arange(band)
    Lmat = np.where(t_idx[:, None] <= t_idx[None, :],
                    decay ** np.maximum(t_idx[None, :] - t_idx[:, None], 0),
                    0.0)
    # KbMat[d', d] = Kb[d - d'] : bulge conv over the current column
    diff = t_idx[None, :] - t_idx[:, None]
    KbMat = np.where((diff >= 2) & (diff <= ML),
                     m.K_bulge[np.clip(diff, 0, ML)], 0.0)

    return tables_from_numpy(dict(
        bp=m.bp, rtype=m.rtype,
        W_stack=m.W_stack, W_int11=m.W_int11, W_int21=m.W_int21,
        W_int22=m.W_int22, W_mism_i=m.W_mism_i, W_mism_h=m.W_mism_h,
        W_d5=m.W_dangle5, W_d3=m.W_dangle3, W_au=m.W_au,
        W_hairpin_len=m.W_hairpin_len, W_bulge_len=m.W_bulge_len,
        K2=K2, Kb=m.K_bulge, Lmat=Lmat, KbMat=KbMat,
        sig_pow=m.sig_pow, inv_sig_pow=m.inv_sig_pow,
        W_mlb=m.W_mlb, W_mli=m.W_mli, W_mlc=m.W_mlc,
        lsig=m.lsig, kT=m.sp.kT), dtype, device)


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------


def _shift_d(x: torch.Tensor, r: int) -> torch.Tensor:
    """Shift along the last (span) axis: out[..., d] = x[..., d - r]
    (negative r reads larger spans); zero fill."""
    if r == 0:
        return x
    if r > 0:
        return F.pad(x, (r, 0))[..., : x.shape[-1]]
    return F.pad(x, (0, -r))[..., -r:]


def _shift_cols(x: torch.Tensor, k: int) -> torch.Tensor:
    """Shift along the leading (column) axis: out[j] = x[j - k] (k may be
    negative: out[j] = x[j + |k|]); zero fill."""
    if k == 0:
        return x
    z = torch.zeros((abs(k),) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    if k > 0:
        return torch.cat([z, x[: x.shape[0] - k]], 0)
    return torch.cat([x[-k:], z], 0)


def _skew_fwd(x: torch.Tensor) -> torch.Tensor:
    """[B, U, D] -> out[b, u, d] = x[b, u, d - u] (zero fill)."""
    B, U, D = x.shape
    xp = F.pad(x, (0, U))
    flat = xp.reshape(B, U * (D + U))
    return flat[:, : U * (D + U - 1)].reshape(B, U, D + U - 1)[:, :, :D]


def _skew_rev(x: torch.Tensor) -> torch.Tensor:
    """[B, U, D] -> out[b, u, d] = x[b, u, d + u] (zero fill)."""
    B, U, D = x.shape
    yp = F.pad(x.flip(1), (0, U))
    flat = yp.reshape(B, U * (D + U))
    z = flat[:, : U * (D + U - 1)].reshape(B, U, D + U - 1)
    return z.flip(1)[:, :, U - 1: U - 1 + D]


def _diag_view(x: torch.Tensor, band: int) -> torch.Tensor:
    """D[i, b, e] = x[i + e, b, e] (0 past the last column) for a
    [N+1, B, band] column-major banded array: the row-major (left-end
    indexed) view."""
    N1, B = x.shape[0], x.shape[1]
    xp = torch.cat([x, torch.zeros((band,) + tuple(x.shape[1:]),
                                   dtype=x.dtype, device=x.device)], 0)
    idx = (torch.arange(N1, device=x.device)[:, None, None]
           + torch.arange(band, device=x.device)[None, None, :])
    return torch.gather(xp, 0, idx.expand(N1, B, band))


def _seq_at(s: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """s[b, idx] for every b, 0 where idx falls outside [0, S)."""
    S = s.shape[1]
    ok = (idx >= 0) & (idx < S)
    v = s[:, idx.clamp(0, S - 1)]
    return torch.where(ok, v, torch.zeros((), dtype=s.dtype,
                                          device=s.device))


def _seq_diag(s: torch.Tensor, n_max: int, band: int, c: int):
    """OUT[j, b, d] = s[b, j - d + c] (reads outside s resolve to 0),
    contiguous, so that the grids gathered through it are too."""
    dev = s.device
    idx = (torch.arange(n_max + 1, device=dev)[:, None]
           - torch.arange(band, device=dev)[None, :] + c)
    return _seq_at(s, idx).permute(1, 0, 2).contiguous()


def _seq_col(s: torch.Tensor, n_max: int, c: int):
    """OUT[j, b, 0] = s[b, j + c] (a [N+1, B, 1] column, broadcast over
    spans)."""
    idx = torch.arange(n_max + 1, device=s.device) + c
    return _seq_at(s, idx).t()[:, :, None]


class _F32Tables:
    """The float32 table views that the grid weights are gathered from
    (the formulation rounds every looked-up weight to float32)."""

    def __init__(self, lm: LinearModel, device):
        def f(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        def i(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=device)

        self.bp = i(lm.bp)
        self.rtbp = i(np.asarray(lm.rtype)[np.asarray(lm.bp)])
        self.stack = f(lm.W_stack)
        self.mi = f(lm.W_mism_i).reshape(-1)
        self.mh = f(lm.W_mism_h).reshape(-1)
        self.i11 = f(lm.W_int11).reshape(-1)
        self.i21 = f(lm.W_int21).reshape(-1)
        self.i22 = f(lm.W_int22).reshape(-1)
        self.d5 = f(lm.W_dangle5[:7])
        self.d3 = f(lm.W_dangle3[:7])
        self.au = f(lm.W_au)


class Grids(NamedTuple):
    """Per-column weight grids, all [N+1, B, band] (leading axis = column j),
    contiguous."""
    stackW: torch.Tensor     # stem stack/stemend transition weight
    t1_nz: torch.Tensor      # bool: pair (i+1, j) exists
    mism_in: torch.Tensor    # prefold for stem as inner helix
    au_in: torch.Tensor
    dangle_ij: torch.Tensor  # exterior/multi2 dangle for pair (i+1, j)
    validC: torch.Tensor     # bool: closing pair (i, j+1) exists (and j != n)
    hpW: torch.Tensor        # hairpin weight * sigma^-d
    mism_out: torch.Tensor   # closing-side mismatch factor
    au_out: torch.Tensor
    mlclose: torch.Tensor    # multi closing weight
    sp10: torch.Tensor       # special small-loop weights
    sp01: torch.Tensor
    sp11: torch.Tensor
    sp12: torch.Tensor
    sp21: torch.Tensor
    sp22: torch.Tensor
    ext_dot: torch.Tensor    # sigma^d * dangle_ij  (exterior scan weight)


def _grid_index(n_max, band, lengths):
    dev = lengths.device
    jj = torch.arange(n_max + 1, device=dev)[:, None, None]
    dd = torch.arange(band, device=dev)[None, None, :]
    return jj, dd, jj - dd, lengths.to(torch.int64)[None, :, None]


def make_grids(t: Tables, s: torch.Tensor, lengths: torch.Tensor,
               n_max: int, band: int, dtype) -> Grids:
    """All inside weight grids. s: [B, n_max + ML + 4] int64 1-based padded
    codes; lengths: [B]."""
    lm = _linmodel(band - 2)
    T = _F32Tables(lm, s.device)
    npdt = _npdt(dtype)

    s_i = _seq_diag(s, n_max, band, 0)
    s_i1 = _seq_diag(s, n_max, band, 1)
    s_i2 = _seq_diag(s, n_max, band, 2)
    s_i3 = _seq_diag(s, n_max, band, 3)
    s_j = _seq_col(s, n_max, 0)
    s_jm1 = _seq_col(s, n_max, -1)
    s_jm2 = _seq_col(s, n_max, -2)
    s_jp1 = _seq_col(s, n_max, 1)

    T1 = T.bp[s_i1, s_j]
    T1r = T.rtbp[s_i1, s_j]
    T2r = T.rtbp[s_i2, s_jm1]
    TC = T.bp[s_i, s_jp1]
    TCr = T.rtbp[s_i, s_jp1]

    jj, dd, ivb, nb = _grid_index(n_max, band, lengths)

    stackW = T.stack[T1, T2r].to(dtype)
    t1_nz = T1 != 0
    mism_in = T.mi[(T1r * 5 + s_jp1) * 5 + s_i].to(dtype)
    au_in = T.au[T1r].to(dtype)

    # dangle for pair (i+1, j) on (i, j)
    w5 = torch.where(ivb > 0, T.d5[T1, s_i], 1.0)
    w3 = torch.where(jj < nb, T.d3[T1, s_jp1], 1.0)
    wau = torch.where((jj == nb) & (T1 > 2), T.au[T1], 1.0)
    dangle_ij = torch.where(t1_nz, w5 * w3 * wau, 1.0).to(dtype)

    # hairpin weight for closing (i, j+1), loop size d (static length part)
    hp_len = np.asarray(lm.W_hairpin_len)[
        np.clip(np.arange(band), 0, len(lm.W_hairpin_len) - 1)]
    inv_sig = np.asarray(lm.inv_sig_pow)[:band]
    hp_mism = T.mh[(TC * 5 + s_i1) * 5 + s_j]
    hp_au = torch.where(TC > 2, T.au[TC], 1.0)
    hpW = torch.where(dd == 3, hp_au, hp_mism)
    hpW = (hpW * torch.as_tensor((hp_len * inv_sig).astype(np.float32),
                                 device=s.device)).to(dtype)

    mism_out = T.mi[(TC * 5 + s_i1) * 5 + s_j].to(dtype)
    au_out = T.au[TC].to(dtype)
    mlclose = (float(lm.W_mlc * lm.W_mli) * T.d3[TCr, s_i1]
               * T.d5[TCr, s_j]).to(dtype)

    def sig(k):
        return float(npdt(np.exp(-k * lm.lsig)))

    b1 = float(lm.W_bulge_len[1])
    X10 = T.rtbp[s_i2, s_j]
    X01 = T.rtbp[s_i1, s_jm1]
    sp10 = (b1 * T.stack[TC, X10]).to(dtype) * sig(1)
    sp01 = (b1 * T.stack[TC, X01]).to(dtype) * sig(1)

    t12r = T.rtbp[s_i2, s_jm2]
    t21r = T.rtbp[s_i3, s_jm1]
    t22r = T.rtbp[s_i3, s_jm2]
    sp11 = T.i11[((TC * 8 + T2r) * 5 + s_i1) * 5 + s_j].to(dtype) * sig(2)
    sp12 = T.i21[(((TC * 8 + t12r) * 5 + s_i1) * 5 + s_jm1) * 5
                 + s_j].to(dtype) * sig(3)
    sp21 = T.i21[(((t21r * 8 + TC) * 5 + s_j) * 5 + s_i1) * 5
                 + s_i2].to(dtype) * sig(3)
    sp22 = T.i22[((((TC * 8 + t22r) * 5 + s_i1) * 5 + s_i2) * 5 + s_jm1)
                 * 5 + s_j].to(dtype) * sig(4)

    validC = (TC != 0) & (jj != nb)
    sigp = torch.as_tensor(np.asarray(lm.sig_pow[:band], np.float32),
                           device=s.device)
    ext_dot = (sigp * dangle_ij).to(dtype)

    return Grids(
        stackW=stackW, t1_nz=t1_nz, mism_in=mism_in, au_in=au_in,
        dangle_ij=dangle_ij, validC=validC, hpW=hpW, mism_out=mism_out,
        au_out=au_out, mlclose=mlclose, sp10=sp10, sp01=sp01, sp11=sp11,
        sp12=sp12, sp21=sp21, sp22=sp22, ext_dot=ext_dot,
    )


def inside_pass(t: Tables, g: Grids, n_max: int, band: int, B: int, dtype):
    """Column scan of the inside recurrences. Returns stacked per-column
    state [N+1, B, band] for stem, stem_mism, stem_au, multi, multi1,
    multi2 and the log-exterior A [N+1, B]."""
    W = band - 2
    npdt = _npdt(dtype)
    dev = g.stackW.device
    sig2 = float(npdt(np.exp(-2 * t.lsig)))
    sig1 = npdt(np.exp(-t.lsig))
    mlb_sig1 = float(npdt(t.W_mlb) * sig1)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    outs = [z(n_max + 1, B, band) for _ in range(6)]
    A_full = z(n_max + 1, B)
    stem_prev = stemend_prev = multi2_prev = stem_prev2 = z(B, band)
    smw = z(B, ML + 1, band)      # stem_mism cols j-1..j-ML-1
    saw = z(B, ML + 1, band)      # stem_au window
    m1w = z(B, W + 1, band)       # multi1 cols j-1..j-W-1
    awin = z(B, W + 2)            # A[j-1-t], t = 0..W+1
    a_prev = z(B)

    for j in range(n_max + 1):
        x = Grids(*(f[j] for f in g))

        # stem: from (i+1, j-1) = prev column, span d-2
        inner = (_shift_d(stem_prev, 2) * x.stackW
                 + _shift_d(stemend_prev, 2))
        stem = torch.where(x.t1_nz, inner * sig2, 0.0)
        stem_m = stem * x.mism_in
        stem_a = stem * x.au_in

        multi2 = (torch.where(x.t1_nz, stem * t.W_mli * x.dangle_ij, 0.0)
                  + _shift_d(multi2_prev, 1) * mlb_sig1)

        # multibif: sum_u multi1[j-u][d-u] * multi2[j][u]
        m1x = _shift_d(_skew_fwd(m1w), 1)  # [b, u-1, d] = m1w[u-1][d-u]
        mb = torch.einsum("bud,bu->bd", m1x[:, :W, :], multi2[:, 1: W + 1])
        multi1 = multi2 + mb

        # multi: triangular decay matmul over spans
        multi = mb @ t.Lmat

        # stemend
        smw_full = torch.cat([stem_m[:, None, :], smw[:, :-1, :]], 1)
        saw_full = torch.cat([stem_a[:, None, :], saw[:, :-1, :]], 1)
        # general interior: G[b, r, d] = sum_u2 smw[b, u2, d] * K2[r, u2]
        G = torch.einsum("bud,ru->brd", smw_full, t.K2)
        gen = _skew_fwd(G).sum(1)          # K2 rows 0..1 are zero
        se = x.hpW + gen * x.mism_out

        # bulges: same-column (u1-side) via banded matmul; window (u2-side)
        bul = stem_a @ t.KbMat
        bul = bul + torch.einsum("bud,u->bd", _skew_fwd(saw_full), t.Kb)
        se = se + bul * x.au_out

        # small-loop specials (cells: (1,0)=cur col d-1, (0,1)=prev d-1,
        # (1,1)=prev d-2, (1,2)=col j-2 d-3, (2,1)=prev d-3, (2,2)=col j-2 d-4)
        se = se + x.sp10 * _shift_d(stem, 1)
        se = se + x.sp01 * _shift_d(stem_prev, 1)
        se = se + x.sp11 * _shift_d(stem_prev, 2)
        se = se + x.sp21 * _shift_d(stem_prev, 3)
        se = se + x.sp12 * _shift_d(stem_prev2, 3)
        se = se + x.sp22 * _shift_d(stem_prev2, 4)

        # multiloop closing
        se = se + multi * x.mlclose
        stemend = torch.where(x.validC, se, 0.0)

        # exterior scan: A[j] = A[j-1] + log1p(sum_dp stem[dp] * ext_dot[dp]
        #                                       * exp(A[j-dp] - A[j-1]))
        expd = torch.exp(awin - a_prev[:, None])  # <= 1
        dot = (stem[:, 1:] * x.ext_dot[:, 1:] * expd[:, : band - 1]).sum(1)
        a_cur = a_prev + torch.log1p(dot)

        for o, v in zip(outs, (stem, stem_m, stem_a, multi, multi1, multi2)):
            o[j] = v
        A_full[j] = a_cur
        stem_prev2, stem_prev = stem_prev, stem
        stemend_prev, multi2_prev = stemend, multi2
        smw, saw = smw_full, saw_full
        m1w = torch.cat([multi1[:, None, :], m1w[:, :-1, :]], 1)
        awin = torch.cat([a_cur[:, None], awin[:, :-1]], 1)
        a_prev = a_cur
    return (*outs, A_full)


class OutsideGrids(NamedTuple):
    """Per-column grids for the outside pass, [N+1, B, band] (column q),
    contiguous."""
    t2_nz: torch.Tensor       # pair (p+1, q) exists
    seed: torch.Tensor        # exp(A[p] + B[q] - logZ + d lsig)
    dangle_pq: torch.Tensor   # same dangle as inside (pair (p+1, q))
    bse_mism_w: torch.Tensor  # prefold weight for bse cells (closing (p, q+1))
    bse_au_w: torch.Tensor
    mism_out2: torch.Tensor   # mismatch postfactor for the (p, q) stem side
    au_out2: torch.Tensor
    contW: torch.Tensor       # helix continuation stack weight (masked)
    mlclose_o: torch.Tensor   # beta multi closing weight
    spo10: torch.Tensor
    spo01: torch.Tensor
    spo11: torch.Tensor
    spo12: torch.Tensor
    spo21: torch.Tensor
    spo22: torch.Tensor
    m2diag: torch.Tensor      # multi2[q+t][t]
    valid_int: torch.Tensor   # (p != 0) & (q != n)


def make_outside_grids(t: Tables, s: torch.Tensor, lengths: torch.Tensor,
                       n_max: int, band: int, dtype, g: Grids,
                       multi2_full, A_full, B_full, logZ) -> OutsideGrids:
    lm = _linmodel(band - 2)
    T = _F32Tables(lm, s.device)
    npdt = _npdt(dtype)

    s_p = _seq_diag(s, n_max, band, 0)
    s_p1 = _seq_diag(s, n_max, band, 1)
    s_pm1 = _seq_diag(s, n_max, band, -1)
    s_q = _seq_col(s, n_max, 0)
    s_q1 = _seq_col(s, n_max, 1)
    s_q2 = _seq_col(s, n_max, 2)

    T2 = T.bp[s_p1, s_q]
    T2r = T.rtbp[s_p1, s_q]
    TC = T.bp[s_p, s_q1]
    TCr = T.rtbp[s_p, s_q1]

    jj, dd, pvb, nb = _grid_index(n_max, band, lengths)

    # seed: exp(A[q-d] + B[q] - logZ + d lsig); the A diagonal is read at
    # float32, as the formulation does
    A_diag = _seq_diag(A_full.t().to(torch.float32), n_max, band, 0)
    seed = torch.exp(A_diag + B_full[:, :, None] - logZ[None, :, None]
                     + (dd * t.lsig).to(torch.float32)).to(dtype)
    seed = torch.where(pvb >= 0, seed, 0.0)

    cmask = TC != 0
    bse_mism_w = torch.where(cmask, T.mi[(TC * 5 + s_p1) * 5 + s_q],
                             0.0).to(dtype)
    bse_au_w = torch.where(cmask, T.au[TC], 0.0).to(dtype)
    mlclose_o = (float(lm.W_mlc * lm.W_mli) * T.d3[TCr, s_p1]
                 * T.d5[TCr, s_q]).to(dtype)

    def sig(k):
        return float(npdt(np.exp(-k * lm.lsig)))

    b1 = float(lm.W_bulge_len[1])

    # closing types of displaced bse cells (p - v1, q + v2)
    def ct(v1, v2):
        return T.bp[_seq_diag(s, n_max, band, -v1), _seq_col(s, n_max, v2 + 1)]

    spo10 = (b1 * T.stack[ct(1, 0), T2r]).to(dtype) * sig(1)
    spo01 = (b1 * T.stack[ct(0, 1), T2r]).to(dtype) * sig(1)
    tc11, tc12, tc21, tc22 = ct(1, 1), ct(1, 2), ct(2, 1), ct(2, 2)
    spo11 = torch.where(tc11 != 0, T.i11[
        ((tc11 * 8 + T2r) * 5 + s_p) * 5 + s_q1].to(dtype) * sig(2), 0.0)
    spo12 = torch.where(tc12 != 0, T.i21[
        (((tc12 * 8 + T2r) * 5 + s_p) * 5 + s_q1) * 5 + s_q2].to(dtype)
        * sig(3), 0.0)
    spo21 = torch.where(tc21 != 0, T.i21[
        (((T2r * 8 + tc21) * 5 + s_q1) * 5 + s_pm1) * 5 + s_p].to(dtype)
        * sig(3), 0.0)
    spo22 = torch.where(tc22 != 0, T.i22[
        ((((tc22 * 8 + T2r) * 5 + s_pm1) * 5 + s_p) * 5 + s_q1) * 5
        + s_q2].to(dtype) * sig(4), 0.0)

    contW = torch.where(cmask & (pvb != 0) & (jj != nb),
                        T.stack[TC, T2r].to(dtype) * sig(2), 0.0)

    m2mask = np.ones(band, np.float32)
    m2mask[band - 1] = 0.0
    m2diag = _diag_view(multi2_full, band) * torch.as_tensor(
        m2mask, device=s.device)

    valid_int = (pvb > 0) & (jj != nb)
    return OutsideGrids(
        t2_nz=T2 != 0, seed=seed, dangle_pq=g.dangle_ij,
        bse_mism_w=bse_mism_w, bse_au_w=bse_au_w,
        mism_out2=T.mi[(T2r * 5 + s_q1) * 5 + s_p].to(dtype),
        au_out2=T.au[T2r].to(dtype),
        contW=contW, mlclose_o=mlclose_o,
        spo10=spo10, spo01=spo01, spo11=spo11, spo12=spo12, spo21=spo21,
        spo22=spo22, m2diag=m2diag.to(dtype), valid_int=valid_int,
    )


def outside_pass(t: Tables, og: OutsideGrids, multi1_full, n_max: int,
                 band: int, B: int, dtype):
    """Column scan (descending q) of the outside recurrences. Returns
    stacked bse, bse_mism, bse_au, b_multi, b_multi2 ([N+1, B, band])."""
    W = band - 2
    npdt = _npdt(dtype)
    dev = og.seed.device
    sig2 = float(npdt(np.exp(-2 * t.lsig)))
    sig1 = npdt(np.exp(-t.lsig))
    decay = float(npdt(t.W_mlb) * sig1)
    W_mli = float(npdt(t.W_mli))

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    # multi1 window source, front-padded: padded index q + band is column q
    m1_pad = torch.cat([z(band, B, band), multi1_full], 0)

    # beta multi decay matmul (upper-triangular, e >= d)
    tt = np.arange(band)
    LmatU = np.where(tt[:, None] >= tt[None, :],
                     float(t.W_mlb * np.exp(-t.lsig)) **
                     np.maximum(tt[:, None] - tt[None, :], 0), 0.0)
    LmatU = torch.as_tensor(LmatU, dtype=dtype, device=dev)
    # bulge conv over same column, larger spans: KbMatU[e, d] = Kb[e - d]
    diff = tt[:, None] - tt[None, :]
    Kb_np = _linmodel(band - 2).K_bulge
    KbMatU = torch.as_tensor(
        np.where((diff >= 2) & (diff <= ML),
                 Kb_np[np.clip(diff, 0, ML)], 0.0), dtype=dtype, device=dev)
    dmask = torch.arange(band, device=dev) < W
    last0 = torch.as_tensor(np.concatenate([np.ones(band - 1), [0.0]]),
                            dtype=dtype, device=dev)

    outs = [z(n_max + 1, B, band) for _ in range(5)]
    bstem_next = z(B, band)              # b_stem col q+1
    bsew = z(B, ML + 1, band)            # bse_mism cols q+1..
    bsaw = z(B, ML + 1, band)
    bse_raw = z(B, 3, band)              # raw bse cols q+1, q+2
    bmbw = z(B, W + 1, band)             # b_multibif cols q+1..q+W+1
    bmulti2_next = z(B, band)

    for q in range(n_max, -1, -1):
        x = OutsideGrids(*(f[q] for f in og))

        # stemend: b_stem[q+1][d+2] * sig^2, masked d < W
        bse = _shift_d(bstem_next, -2) * sig2
        bse = torch.where(x.valid_int & dmask[None, :], bse, 0.0)
        bse_m = bse * x.bse_mism_w
        bse_a = bse * x.bse_au_w

        # multi: upper-triangular decay matmul of the closing term
        clos = torch.where(x.valid_int, bse * x.mlclose_o, 0.0)
        bmulti = torch.where(x.valid_int, clos @ LmatU, 0.0)

        # multi1: sum_t bmb[q+t][t+d] * multi2[q+t][t]
        bmbx = _shift_d(_skew_rev(bmbw), -1)  # [b, t-1, d] = bmbw[t-1][d+t]
        bm1 = torch.einsum("btd,bt->bd", bmbx[:, :W, :],
                           x.m2diag[:, 1: W + 1])
        bm1 = torch.where(x.valid_int, bm1, 0.0)
        bmb = bm1 + bmulti  # b_multibif

        # multi2: bm1 + decayed next-column + same-column bif closings.
        # M1COLS[b, d, f] = multi1[q - d][b, f]
        M1COLS = m1_pad[q + 1: q + 1 + band].flip(0).permute(1, 0, 2)
        # same-column reduction bound: e = d + f <= W (raccess.cpp:342)
        bmb_masked = bmb * last0
        bm2 = bm1 + _shift_d(bmulti2_next, -1) * decay
        bmb_t = bmb_masked[:, None, :].expand(B, W, band)
        bmb_sh = _shift_d(_skew_rev(bmb_t), -1)  # [b, f-1, d] = bmb[d+f]
        bm2 = bm2 + torch.einsum("bfd,bdf->bd", bmb_sh,
                                 M1COLS[:, :, 1: W + 1])
        bm2 = torch.where(x.valid_int, bm2, 0.0)

        # stem
        out = x.seed * x.dangle_pq
        bsew_cur = torch.cat([bse_m[:, None, :], bsew[:, :-1, :]], 1)
        bsaw_cur = torch.cat([bse_a[:, None, :], bsaw[:, :-1, :]], 1)
        Gp = torch.einsum("bud,ru->brd", bsew_cur, t.K2)
        gen = _skew_rev(Gp).sum(1)
        out = out + gen * x.mism_out2

        bul = bse_a @ KbMatU
        bul = bul + torch.einsum("bud,u->bd", _skew_rev(bsaw_cur), t.Kb)
        out = out + bul * x.au_out2

        # specials: bse cells (v1, v2) at col q+v2, span d+v1+v2
        bse_q1 = bse_raw[:, 0, :]
        bse_q2 = bse_raw[:, 1, :]
        out = out + x.spo10 * _shift_d(bse, -1)
        out = out + x.spo01 * _shift_d(bse_q1, -1)
        out = out + x.spo11 * _shift_d(bse_q1, -2)
        out = out + x.spo21 * _shift_d(bse_q1, -3)
        out = out + x.spo12 * _shift_d(bse_q2, -3)
        out = out + x.spo22 * _shift_d(bse_q2, -4)

        # helix continuation + multiloop participation
        out = out + _shift_d(bstem_next, -2) * x.contW
        out = out + bm2 * W_mli * x.dangle_pq
        bstem = torch.where(x.t2_nz, out, 0.0)

        for o, v in zip(outs, (bse, bse_m, bse_a, bmulti, bm2)):
            o[q] = v
        bstem_next = bstem
        bsew, bsaw = bsew_cur, bsaw_cur
        bse_raw = torch.cat([bse[:, None, :], bse_raw[:, :-1, :]], 1)
        bmbw = torch.cat([bmb_masked[:, None, :], bmbw[:, :-1, :]], 1)
        bmulti2_next = bm2
    return tuple(outs)


def b_outer_scan(stem_full, ext_dot_full, n_max: int, band: int, B: int,
                 dtype, lengths) -> torch.Tensor:
    """log beta_outer backward scan (reference: raccess.cpp:260-271).

    B[i] = B[i+1] + log1p(sum_dp stem[i+dp][dp] * ext_dot[i+dp][dp]
                           * exp(B[i+dp] - B[i+1]))
    using the diagonal view of the stacked inside outputs."""
    sd = _diag_view(stem_full * ext_dot_full, band)  # [i, B, dp]
    dev = sd.device
    bwin = torch.zeros((B, band), dtype=dtype, device=dev)
    b_next = torch.zeros((B,), dtype=dtype, device=dev)
    Bl = torch.zeros((n_max + 1, B), dtype=dtype, device=dev)
    for i in range(n_max, -1, -1):
        expd = torch.exp(bwin - b_next[:, None])
        dot = (sd[i][:, 1:] * expd[:, : band - 1]).sum(1)
        b_cur = b_next + torch.log1p(dot)
        Bl[i] = b_cur
        bwin = torch.cat([b_cur[:, None], bwin[:, :-1]], 1)
        b_next = b_cur
    # positions beyond each sequence's length must read 0 (B[n] = 0); the
    # scan ran over padding columns where stems are 0, so B is constant
    # (= B[n]) there — subtract that constant per sequence.
    offs = Bl.gather(0, lengths.to(torch.int64)[None, :])
    return Bl - offs


class ProbGrids(NamedTuple):
    """Weight grids for the probability biloop specials, on the bse-cell
    grid [N+1(col jc), B, band(ecell)]; closing pair is (i, j) = (jc-ecell,
    jc+1)."""
    pb10: torch.Tensor
    pb01: torch.Tensor
    pb11: torch.Tensor
    pb12: torch.Tensor
    pb21: torch.Tensor
    pb22: torch.Tensor


def make_prob_grids(t: Tables, s: torch.Tensor, n_max: int, band: int,
                    dtype) -> ProbGrids:
    lm = _linmodel(band - 2)
    T = _F32Tables(lm, s.device)
    npdt = _npdt(dtype)

    # cell grid: [col jc][ecell]; closing pair (i, j) = (jc-ecell, jc+1)
    s_i = _seq_diag(s, n_max, band, 0)
    s_i1 = _seq_diag(s, n_max, band, 1)
    s_i2 = _seq_diag(s, n_max, band, 2)
    s_i3 = _seq_diag(s, n_max, band, 3)
    s_j = _seq_col(s, n_max, 1)
    s_jm1 = _seq_col(s, n_max, 0)
    s_jm2 = _seq_col(s, n_max, -1)
    s_jm3 = _seq_col(s, n_max, -2)

    TCL = T.bp[s_i, s_j]
    nz = TCL != 0

    def sig(k):
        return float(npdt(np.exp(-k * lm.lsig)))

    b1 = float(lm.W_bulge_len[1])
    t10 = T.rtbp[s_i2, s_jm1]
    t01 = T.rtbp[s_i1, s_jm2]
    t11 = T.rtbp[s_i2, s_jm2]
    t12 = T.rtbp[s_i2, s_jm3]
    t21 = T.rtbp[s_i3, s_jm2]
    t22 = T.rtbp[s_i3, s_jm3]

    def mask(w):
        return torch.where(nz, w, 0.0).to(dtype)

    pb10 = mask(b1 * T.stack[TCL, t10]) * sig(1)
    pb01 = mask(b1 * T.stack[TCL, t01]) * sig(1)
    pb11 = mask(T.i11[((TCL * 8 + t11) * 5 + s_i1) * 5 + s_jm1]) * sig(2)
    pb12 = mask(T.i21[(((TCL * 8 + t12) * 5 + s_i1) * 5 + s_jm2) * 5
                      + s_jm1]) * sig(3)
    pb21 = mask(T.i21[(((t21 * 8 + TCL) * 5 + s_jm1) * 5 + s_i1) * 5
                      + s_i2]) * sig(3)
    pb22 = mask(T.i22[((((TCL * 8 + t22) * 5 + s_i1) * 5 + s_i2) * 5
                       + s_jm2) * 5 + s_jm1]) * sig(4)
    return ProbGrids(pb10, pb01, pb11, pb12, pb21, pb22)


def probability_pass(t: Tables, g: Grids, pg: ProbGrids, ins, outs,
                     A_full, B_full, logZ, w: int, n_max: int, band: int,
                     dtype):
    """Window-unpaired probabilities for window sizes w and w+1, vectorized
    over the grid (reference: raccess.cpp:421-681). Returns the 8 component
    arrays indexed [N+2, B] by window start x (1-based)."""
    W = band - 2
    npdt = _npdt(dtype)
    stem, stem_m, stem_a, multi, multi1, multi2, _ = ins
    bse, bse_m, bse_a, b_multi, b_multi2 = outs
    Np = n_max + 2
    Bsz = stem.shape[1]
    dev = stem.device

    def padx(a):
        # [N+1, ...] -> [N+2, ...] with a zero last row
        return F.pad(a, (0, 0, 0, 1))[:Np]

    def xarr():
        return torch.zeros((Np, Bsz), dtype=dtype, device=dev)

    # ---- exterior: exp(A[x-1] + B[x+w-1] - logZ) --------------------------
    def exterior(wsz):
        a = _shift_cols(A_full, 1)                      # A[x-1] at row x
        b = _shift_cols(B_full, -(wsz - 1))             # B[x+wsz-1] at row x
        return padx(torch.exp(a + b - logZ[None, :]))

    ext_w = exterior(w)
    ext_w1 = exterior(w + 1)

    # ---- hairpin ----------------------------------------------------------
    # Cell (i, j) lives at [jc = j-1][ecell = j-i-1] and covers windows
    # x in [i+1, j-w]. With offset o = j - x:
    #   total[x] = sum_o SS[x+o-1][o],  SS[c][k] = sum_{e >= k} HP[c][e]
    # The suffix sums are added one span at a time, in float64, and each
    # rounded to the dtype: the order and precision of the CPU's cumsum,
    # the same for every batch. torch.cumsum on the card rounds otherwise
    # at another batch shape, so a sequence's accessibility would depend
    # on its batch-mates and padding (access_batch_ab.py).
    HP = bse * g.hpW
    SS = {}
    run_ss = torch.zeros_like(HP[:, :, 0], dtype=torch.float64)
    for e in range(band - 1, w - 1, -1):
        run_ss = run_ss + HP[:, :, e].double()
        SS[e] = run_ss.to(dtype)
    hp_b = xarr()
    hp_c = xarr()
    for o in range(w, band - 1):
        term = padx(_shift_cols(SS[o], -(o - 1)))
        hp_b = hp_b + term
        if o > w:
            hp_c = hp_c + term

    # ---- multiloop --------------------------------------------------------
    def multi_prob(wsz):
        sigf = float(npdt(np.exp(-wsz * t.lsig)))
        part = torch.zeros((n_max + 1, Bsz), dtype=dtype, device=dev)
        for tt in range(wsz, band):
            prod = b_multi[:, :, tt] * multi[:, :, tt - wsz]
            part = part + _shift_cols(prod, 1 - tt)
        for tt in range(0, W - wsz + 1):
            prod = (_shift_cols(b_multi2[:, :, tt + wsz], -(wsz - 1))
                    * _shift_cols(multi2[:, :, tt], 1))
            part = part + prod
        return padx(part * sigf)

    mp_w = multi_prob(w)
    mp_w1 = multi_prob(w + 1)

    # ---- bulge/internal ("biloop") ---------------------------------------
    # Per-(u1)/(u2) reduced contributions are collected into srcL[u1]
    # (indexed by the outer cell's left end i) and srcR[u2] (indexed by jc),
    # then spread over their bounded windows with nonnegative suffix-sum
    # shifts (f32-safe).
    lm = _linmodel(band - 2)
    KInt = np.zeros((2 * ML + 1, ML + 1))
    for r in range(2 * ML + 1):
        for u2 in range(ML + 1):
            if 0 <= r - u2 <= ML:
                KInt[r, u2] = lm.K_int[r - u2, u2]
    Kb = lm.K_bulge

    D_bse_m = _diag_view(bse_m, band)
    D_bse_a = _diag_view(bse_a, band)
    D_sm = _diag_view(stem_m, band)
    D_sa = _diag_view(stem_a, band)

    nrows = bse.shape[0]
    zrow = torch.zeros((nrows, Bsz), dtype=dtype, device=dev)
    srcL = {u: zrow for u in range(ML + 1)}
    srcR = {u: zrow for u in range(ML + 1)}

    def band_conv(x, weights):
        """x @ K for the banded K[e, e + u] = weights[u] (u >= 1, in the
        working dtype): x shifted u cells along the band axis times
        weights[u], added in ascending u, one elementwise product and add
        each. A matrix product would sum otherwise: on the card its order
        depends on the batch's row count, and a row must get the same
        bits in any batch."""
        out = torch.zeros_like(x)
        for u, wt in weights:
            if u < band:
                out[..., u:] += x[..., : band - u] * float(npdt(wt))
        return out

    # general interior, right side (per u2)
    for u2 in range(max(1, w), ML + 1):
        H = band_conv(stem_m, [(u1, KInt[u1 + u2, u2])
                               for u1 in range(1, ML - u2 + 1)])
        Hs = _shift_cols(_shift_d(H, u2), u2)
        srcR[u2] = srcR[u2] + (bse_m * Hs).sum(2)

    # general interior, left side (per u1)
    for u1 in range(max(1, w), ML + 1):
        G = band_conv(D_sm, [(u2, KInt[u1 + u2, u2])
                             for u2 in range(1, ML - u1 + 1)])
        Gs = _shift_cols(_shift_d(G, u1), -u1)
        srcL[u1] = srcL[u1] + (D_bse_m * Gs).sum(2)

    # bulges
    for u in range(max(2, w), ML + 1):
        kb = float(npdt(Kb[u]))
        srcL[u] = srcL[u] + (D_bse_a * _shift_cols(
            _shift_d(D_sa, u), -u)).sum(2) * kb
        srcR[u] = srcR[u] + (bse_a * _shift_cols(
            _shift_d(stem_a, u), u)).sum(2) * kb

    # small-loop specials spread only when their u reaches w (w <= 2)
    specials = [(1, 0, pg.pb10), (0, 1, pg.pb01), (1, 1, pg.pb11),
                (1, 2, pg.pb12), (2, 1, pg.pb21), (2, 2, pg.pb22)]
    for u1, u2, wgrid in specials:
        if u1 < w and u2 < w:
            continue
        cell = bse * wgrid * _shift_cols(_shift_d(stem, u1 + u2), u2)
        if u2 >= w:
            srcR[u2] = srcR[u2] + cell.sum(2)
        if u1 >= w:
            srcL[u1] = srcL[u1] + _diag_view(cell, band).sum(2)

    # boundaries: left x = i + u1 + 1 - w ; right x = jc + 1 - w
    bnd_b = xarr()
    for u in range(w, ML + 1):
        bnd_b = bnd_b + padx(_shift_cols(srcL[u], u + 1 - w))
    sumR = zrow
    for u in range(w, ML + 1):
        sumR = sumR + srcR[u]
    bnd_b = bnd_b + padx(_shift_cols(sumR, -(w - 1)))

    # conditional windows: left x = i + tshift (u1 >= tshift + w);
    # right x = jc + 1 - tau (u2 >= tau, tau >= w + 1)
    bi_c = xarr()
    run = zrow
    for tshift in range(ML - w, 0, -1):
        run = run + srcL[tshift + w]
        bi_c = bi_c + padx(_shift_cols(run, tshift))
    runR = zrow
    for tau in range(ML, w, -1):
        runR = runR + srcR[tau]
        bi_c = bi_c + padx(_shift_cols(runR, -(tau - 1)))

    # The reference sums these in linear space when |logZ| <= 690 and in
    # log space otherwise (raccess.cpp:614-771, exact_engine.cc:639).
    # Linear branch: the raw (unnormalized) sums are cast to float32 before
    # the log, so values above f32-max collapse to fmath::log(inf) = 128*ln2
    # — the normalized probability is clamped at e^(88.72 - logZ) — and the
    # conditional part is dropped when the raw boundary sum is exactly zero
    # (approximated here by "boundary underflows to 0"; deviations are
    # limited to windows whose boundary weight is below ~e^-700). Log
    # branch: neither applies; the sums are exact.
    lin = (logZ >= -690) & (logZ <= 690)
    clamp = torch.exp(float(npdt(128.0 * np.float32(np.log(2.0))))
                      - logZ[None, :])
    bi_b = torch.where(lin, torch.where(
        bnd_b > 0, torch.minimum(bnd_b + bi_c, clamp), 0.0), bnd_b + bi_c)
    bi_c = torch.where(lin, torch.minimum(bi_c, clamp), bi_c)

    return ext_w, ext_w1, hp_b, hp_c, bi_b, bi_c, mp_w, mp_w1


def outside_inputs(t: Tables, s_padded, lengths, n_max: int, band: int,
                   dtype, g: Grids, ins, checked: bool = False):
    """The outside scan's grids and multi1 from the inside scan's eight
    outputs `ins` (six planes, A_full, B_full); lengths int64 (`checked`:
    their range checked on the host). The grids come from
    ops/access_grids.py: its kernel on cuda, make_outside_grids on the
    CPU."""
    # imported here: ops/access_grids.py imports this module
    from priblast_tpu_torch.ops import access_grids

    A_full, B_full = ins[6], ins[7]
    logZ = A_full.gather(0, lengths[None, :])[0]
    og = access_grids.outside_grids(t, s_padded, lengths, n_max, band, dtype,
                                    g, ins[5], A_full, B_full, logZ,
                                    checked=checked)
    return og, ins[4]


def scan_probabilities(t: Tables, g: Grids, s_padded, lengths,
                       min_acc_len: int, n_max: int, band: int, dtype, ins,
                       outs):
    """(p_w, p_w1), each [N+2, B], from the inside scan's eight outputs
    `ins` and the outside scan's five `outs`; lengths int64."""
    A_full, B_full = ins[6], ins[7]
    logZ = A_full.gather(0, lengths[None, :])[0]
    pg = make_prob_grids(t, s_padded, n_max, band, dtype)
    (ext_w, ext_w1, hp_b, hp_c, bi_b, bi_c, mp_w, mp_w1) = probability_pass(
        t, g, pg, ins[:7], outs, A_full, B_full, logZ, min_acc_len, n_max,
        band, dtype)
    return ext_w + hp_b + bi_b + mp_w, ext_w1 + hp_c + bi_c + mp_w1


def _scanned(w_span: int, n_max: int, dtype, s_padded: torch.Tensor,
             lengths: torch.Tensor, t: Tables | None):
    """The weight grids and both column scans of a batch whose lengths are
    checked: (t, g, ins, outs), the inputs of the probability pass."""
    # imported here: the ops modules import this module
    from priblast_tpu_torch.ops import access_grids, access_scan

    band = w_span + 2
    if t is None:
        t = make_tables(w_span, dtype=dtype, device=s_padded.device)
    g = access_grids.inside_grids(t, s_padded, lengths, n_max, band, dtype,
                                  checked=True)
    ins = access_scan.inside_scan(t, g, lengths, n_max, band, dtype,
                                  checked=True)
    og, multi1 = outside_inputs(t, s_padded, lengths, n_max, band, dtype, g,
                                ins, checked=True)
    outs = access_scan.outside_scan(t, og, multi1, n_max, band, dtype)
    return t, g, ins, outs


def _checked_lengths(s_padded, lengths, n_max: int, checked: bool):
    """lengths as int64, their range checked here (a read from the device)
    unless the caller has `checked` it on the host."""
    # imported here: the ops modules import this module
    from priblast_tpu_torch.ops import access_scan

    lengths = lengths.to(torch.int64)
    if not checked:
        access_scan._check_lengths(lengths, n_max, s_padded.shape[0],
                                   s_padded.device)
    return lengths


def _two_rows(s_padded, lengths):
    """A one-row batch as two copies of its row: the plain versions'
    matmuls and einsums sum in another order for a single row (a
    matrix-vector product), and a row must get the same bits in any batch
    (the shards of a split batch may hold one row)."""
    return s_padded.expand(2, -1).contiguous(), lengths.expand(2).contiguous()


def window_probabilities(w_span: int, min_acc_len: int, n_max: int, dtype,
                         s_padded: torch.Tensor, lengths: torch.Tensor,
                         t: Tables | None = None, *, checked: bool = False):
    """Unpaired probabilities of every window of size w and w + 1, in
    `dtype`: (p_w, p_w1), each [N+2, B] indexed by 1-based window start.
    The weight grids run through ops/access_grids.py, the column scans
    through ops/access_scan.py and the probability pass through
    ops/access_prob.py: the kernels on cuda, their plain versions on the
    CPU. `t`: make_tables(w_span, dtype) on the batch's device, built here
    where not given. The lengths must lie in [0, n_max]: unless the caller
    has `checked` that on the host, it is checked here, once, before any
    grid is built (a read from the device); the wrappers then read
    none. Off the main path, which takes batch_energies."""
    # imported here: the ops modules import this module
    from priblast_tpu_torch.ops import access_prob

    lengths = _checked_lengths(s_padded, lengths, n_max, checked)
    if s_padded.shape[0] == 1:
        p_w, p_w1 = window_probabilities(
            w_span, min_acc_len, n_max, dtype, *_two_rows(s_padded, lengths),
            t, checked=True)
        return p_w[:, :1].contiguous(), p_w1[:, :1].contiguous()
    t, g, ins, outs = _scanned(w_span, n_max, dtype, s_padded, lengths, t)
    return access_prob.window_probs(t, g, s_padded, lengths, min_acc_len,
                                    n_max, w_span + 2, dtype, ins, outs,
                                    checked=True)


def batch_energies(w_span: int, min_acc_len: int, n_max: int, dtype,
                   s_padded: torch.Tensor, lengths: torch.Tensor, kT: float,
                   t: Tables | None = None, *, checked: bool = False):
    """The window energies of accessibility_from_probabilities on the
    probabilities of window_probabilities, as one [2, B, n_max] float32
    tensor (acc, then cond), through the same kernels (their plain
    versions on the CPU) but for the last: ops/access_prob.py:
    window_energies, whose sum launch writes the energies itself. The
    arguments and the lengths' check as window_probabilities'."""
    # imported here: the ops modules import this module
    from priblast_tpu_torch.ops import access_prob

    lengths = _checked_lengths(s_padded, lengths, n_max, checked)
    if s_padded.shape[0] == 1:
        return batch_energies(w_span, min_acc_len, n_max, dtype,
                              *_two_rows(s_padded, lengths), kT, t,
                              checked=True)[:, :1].contiguous()
    t, g, ins, outs = _scanned(w_span, n_max, dtype, s_padded, lengths, t)
    return access_prob.window_energies(t, g, s_padded, lengths, min_acc_len,
                                       n_max, w_span + 2, dtype, ins, outs,
                                       kT, checked=True)


def accessibility_from_probabilities(p_w, p_w1, lengths, w: int,
                                     n_max: int, kT: float):
    """-kT log p / 1000 in float32 (the reference's output type): acc
    [B, N] (valid [0, n-w]) and conditional cond [B, N] (valid [w, n-1])."""
    f32 = torch.float32
    dev = p_w.device
    xs = torch.arange(n_max + 2, device=dev)[:, None]
    nvec = lengths.to(torch.int64)[None, :]
    val_w = (xs >= 1) & (xs + w - 1 <= nvec)
    val_w1 = (xs >= 1) & (xs + w <= nvec)
    tiny = float(np.finfo(np.float32).tiny)
    kT32 = float(np.float32(kT))
    logp_w = torch.log(torch.clamp(p_w, min=tiny).to(f32))
    logp_w1 = torch.log(torch.clamp(p_w1, min=tiny).to(f32))
    acc_x = torch.where(val_w, (-logp_w * kT32) / 1000, 0.0)
    cond_x = torch.where(val_w1, (-logp_w1 * kT32) / 1000 - acc_x, 0.0)
    # acc[x-1] = acc_x[x]; cond[x+w-1] = cond_x[x]
    acc = acc_x[1: n_max + 1].t()
    cond = _shift_cols(cond_x, w)[1: n_max + 1].t()
    return acc, cond


class BatchedRaccess:
    """Public entry: accessibility for batches of equal-padded sequences,
    each batch's rows split over a list of torch devices (data parallel:
    base pairs never span sequences, so the shards are independent; the
    counterpart of the reference's per-rank sequence distribution,
    src/fastafile_reader.cpp:135-314). The tables are built once per
    distinct device."""

    def __init__(self, w_span: int, min_acc_len: int, dtype="float32", *,
                 devices):
        self.w = w_span
        self.d = min_acc_len
        self.dtype = _DTYPES[dtype]
        self.devices = dist.device_list(devices)
        self.kT = float(_linmodel(w_span).sp.kT)
        self._tables = {dev: make_tables(w_span, self.dtype, dev)
                        for dev in dist.distinct(self.devices)}

    def run(self, codes_batch: np.ndarray, lengths: np.ndarray):
        """codes_batch: [B, n_max] uint8 (0..4, zero padded); lengths: [B]
        int. Returns (acc, cond) float32 numpy [B, n_max] with the same
        layout as the exact engine (acc valid [0, n-d], cond valid
        [d, n-1]). The rows are split over the devices (dist.split_rows;
        an empty shard runs nothing), each shard at the batch's n_max on a
        host thread of its own, and joined in order."""
        B, n_max = codes_batch.shape
        lens = np.asarray(lengths, np.int64)
        # the lengths' range, checked here on the host, once per batch: the
        # device wrappers then read none back (ops/access_scan.py)
        if lens.shape != (B,) or (B and (lens.min() < 0
                                         or lens.max() > n_max)):
            raise ValueError(f"lengths must be {B} values in [0, {n_max}]")
        s = np.zeros((B, n_max + ML + 4), dtype=np.int64)
        s[:, 1: n_max + 1] = codes_batch
        shards = [(dev, lo, hi) for dev, (lo, hi) in zip(
            self.devices, dist.split_rows(B, len(self.devices))) if hi > lo]
        parts = dist.run_sharded(
            lambda dev, lo, hi: self._run_rows(dev, s[lo:hi], lens[lo:hi],
                                               n_max), shards)
        if not parts:
            empty = np.zeros((0, n_max), np.float32)
            return empty, empty.copy()
        return (np.concatenate([a for a, _ in parts]),
                np.concatenate([c for _, c in parts]))

    def _run_rows(self, dev, s: np.ndarray, lens: np.ndarray, n_max: int):
        s = torch.as_tensor(s, device=dev)
        lens = torch.as_tensor(lens, device=dev)
        with torch.no_grad():
            # acc and cond as one [2, B, n_max] tensor: one copy back
            out = batch_energies(self.w, self.d, n_max, self.dtype, s, lens,
                                 self.kT, self._tables[dev], checked=True)
        out = out.cpu().numpy()
        return out[0], out[1]
