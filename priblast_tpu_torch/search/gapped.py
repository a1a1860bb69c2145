"""Batched gapped extension on the device (PyTorch), over flat buffers.

Reference semantics: src/gapped_extension.cpp:33-319 (mirrored by the
native host engine, ops/native/search.cc gapped_extend_one). The
reference's pruned stem-candidate list (CheckStemCandidate,
gapped_extension.cpp:213-217) only admits predecessors whose interior loop
size u1+u2 = (i-k-1)+(j-l-1) is <= dropout, so the DP is a *banded*
anti-diagonal sweep: each diagonal L evaluates all cells (i, L-i) as a min
over the (dropout+1)(dropout+2)/2 static (u1,u2) predecessor offsets.

Per direction (`_extend_dir`):
- per-hit character windows and boundary offsets (gathers from the flat
  buffers);
- the prefix accessibility chains extq / extdb, chained SEQUENTIALLY one
  entry at a time as the reference does (a tree-ordered cumsum drifts ~1
  ulp in float32 and flips near-tie argmins);
- the energy "planes": every table term of the DP is a function of a few
  characters around a cell, so each is looked up once per call, directly
  as ``M[q-side index, d-side index]``, into hit-major diagonal rows
  ``[B, max_ext+1, W]`` (row D, lane i = cell (i, D - i));
- the sweep itself (ops/gapped_sweep.py: the CUDA kernel on the card, its
  plain version on the CPU);
- the traceback, a fixed-length walk over the predecessor rows.

Extension is capped at `max_ext` diagonals; hits still active at the cap
are flagged `overflow` and the caller re-runs them from their
pre-extension state on the host engine.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from priblast_tpu_torch.ops import gapped_sweep as sweep_op
from priblast_tpu_torch.utils import thermo

BIG = 10_000_000  # "unbounded" boundary sentinel (reference MAX_EXTENSION,
#                   gapped_extension.cpp:30)

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@functools.lru_cache(maxsize=1)
def _tables_np():
    r = thermo.RAW
    f = lambda x: np.asarray(x, np.float64).reshape(-1)  # noqa: E731
    return dict(
        bp=r.BP_pair.reshape(-1).astype(np.int64),
        rtype=r.rtype.astype(np.int64),
        stack=f(r.stack37),
        bulge=f(r.bulge37),
        i11=f(r.int11_37),
        i21=f(r.int21_37),
        i22=f(r.int22_37),
        mismI=f(r.mismatchI37),
        intloop=f(r.internal_loop37),
        lxc=np.float64(thermo.RAW.lxc37),
        term_au=np.float64(thermo.RAW.TerminalAU),
    )


def _np_wob(t):
    # wobble pair types (reference: gapped_extension.cpp:340)
    return (t == 3) | (t == 4)


def _bulge_const(s: int) -> float:
    r = _tables_np()
    return float(r["bulge"][s] if s <= 30 else
                 r["bulge"][30] + r["lxc"] * np.log(s / 30.0))


@functools.lru_cache(maxsize=8)
def _plane_tables(flag: int):
    """Composite numpy lookup tables over combined-character indices for
    the per-cell energy planes. Conventions: q-side combined index is
    (qm[x]*5 + aux1)(*5 + aux2); d-side likewise with dm[y] leading. Value
    tables are raw Turner units; the single /100 happens at the working
    dtype. Compositions mirror ops/native/search.cc loop37_gapped and
    gapped_extension.cpp:426-473."""
    r = _tables_np()
    bp = r["bp"].reshape(5, 5)
    rt = r["rtype"]
    t0 = rt[bp] if flag == 1 else bp      # flag-adjusted cell pair type
    st = rt[t0]                           # stored cell type (= rt[type1])
    mism = r["mismI"]
    stack = r["stack"]
    i11, i21, i22 = r["i11"], r["i21"], r["i22"]
    b1 = float(r["bulge"][1])

    # axis order: C1=qm[x], QA=q-aux1, QE=q-aux2, C2=dm[y], DA=d-aux1,
    # DG=d-aux2 (np.ix_ broadcasting)
    A5 = list(range(5))
    C1, QA, C2, DA = np.ix_(A5, A5, A5, A5)
    T = t0[C1, C2]
    S_ = st[QA, DA]

    def q2d2(arr):
        return arr.reshape(25, 25)

    out = {}
    # mism_shared: aux = (qm[x-1], dm[y-1])
    out["MS"] = q2d2(mism[(T * 5 + QA) * 5 + DA] if flag == 0 else
                     mism[(T * 5 + DA) * 5 + QA])
    # vm (predecessor-cell mismatch, stored per cell): aux = (qm[x+1],
    # dm[y+1]); reference mism_row with st_row = rt[type1]
    ST = st[C1, C2]
    out["VM"] = q2d2(mism[(ST * 5 + DA) * 5 + QA] if flag == 0 else
                     mism[(ST * 5 + QA) * 5 + DA])
    # helix x'=1 badness: aux = (qm[x+1], dm[y-1]); includes the wobble
    # cross-term with t0 (reference: gapped_extension.cpp:342-364)
    T1 = t0[QA, DA]
    out["BAD1"] = q2d2(((T1 == 0) |
                        (_np_wob(T) & _np_wob(T1))).astype(np.float64))
    # helix x'>=2 badness: single chars (qm[x+x'], dm[y-x'])
    out["BADX"] = (t0 == 0).astype(np.float64)

    # stack-class values (aux q = qm[x-u1-1+...], aux d = ...):
    #   STK00: pred (x-1, y-1);  STK10: pred (x-2, y-1);  STK01: (x-1, y-2)
    def stk(pt):
        return stack[T * 7 + pt] if flag == 0 else stack[pt * 7 + T]

    out["STK00"] = q2d2(stk(S_))
    out["STK10"] = q2d2(b1 + stk(S_))   # aux: (qm[x-2], dm[y-1])
    out["STK01"] = q2d2(b1 + stk(S_))   # aux: (qm[x-1], dm[y-2])
    # small-internal specials. V11 carries tb in its char axes;
    # V12/V21/V22 are per-tb slates (tb = predecessor stored type 0..6).
    C1, QA, QE, C2, DA, DG = np.ix_(A5, A5, A5, A5, A5, A5)
    T = t0[C1, C2]
    TB = st[QE, DG]

    def q3d3(arr):
        return arr.reshape(125, 125)

    if flag == 0:
        v11 = i11[((T * 8 + TB) * 5 + QA) * 5 + DA]
    else:
        v11 = i11[((TB * 8 + T) * 5 + QA) * 5 + DA]
    out["V11"] = q3d3(v11)

    C1, QA, C2, DA, DG = np.ix_(A5, A5, A5, A5, A5)
    T = t0[C1, C2]
    v12, v21, v22 = [], [], []
    for tb in range(7):
        if flag == 0:
            v12.append(i21[(((T * 8 + tb) * 5 + QA) * 5 + DG) * 5 + DA])
        else:
            v12.append(i21[(((tb * 8 + T) * 5 + QA) * 5 + DA) * 5 + DG])
        v12[-1] = v12[-1].reshape(25, 125)        # q=(c1,qa) d=(c2,da,dg)
    C1, QA, QE, C2, DA = np.ix_(A5, A5, A5, A5, A5)
    T = t0[C1, C2]
    for tb in range(7):
        if flag == 0:
            z = i21[(((tb * 8 + T) * 5 + DA) * 5 + QA) * 5 + QE]
        else:
            z = i21[(((T * 8 + tb) * 5 + DA) * 5 + QE) * 5 + QA]
        v21.append(z.reshape(125, 25))            # q=(c1,qa,qe) d=(c2,da)
    C1, QA, QE, C2, DA, DG = np.ix_(A5, A5, A5, A5, A5, A5)
    T = t0[C1, C2]
    for tb in range(7):
        if flag == 0:
            z = i22[((((T * 8 + tb) * 5 + QA) * 5 + QE) * 5 + DG) * 5 + DA]
        else:
            z = i22[((((tb * 8 + T) * 5 + QE) * 5 + QA) * 5 + DA) * 5 + DG]
        v22.append(z.reshape(125, 125))
    out["V12"] = np.stack(v12)                    # [7, 25, 125]
    out["V21"] = np.stack(v21)                    # [7, 125, 25]
    out["V22"] = np.stack(v22)                    # [7, 125, 125]
    # bit/bool tables of the flag-adjusted type
    out["NZ0"] = (t0 != 0).astype(np.float64)
    out["W0"] = _np_wob(t0).astype(np.float64)
    out["AU0"] = (t0 > 2).astype(np.float64)
    out["STT"] = st.astype(np.float64)            # stored type (0..6)
    return out


def tables_from_numpy(fields: dict, dtype=torch.float32, device="cpu"):
    """The plane tables as device tensors, built from numpy arrays (one
    entry per name of `_plane_tables`): value tables in `dtype`, the bit
    and stored-type tables as int64 lookups."""
    out = {}
    for k, v in fields.items():
        v = np.asarray(v)
        if k in ("BAD1", "BADX", "NZ0", "W0", "AU0", "STT"):
            out[k] = torch.tensor(v.astype(np.int64), device=device)
        else:
            out[k] = torch.tensor(v, dtype=dtype, device=device)
    return out


def _gather_chars(seq, start, sign: int, xw: int):
    """raw[b, x] = seq[start_b + sign*x], 0 outside bounds; and the GetChar
    mapping (reference: gapped_extension.cpp:401-407)."""
    n = seq.shape[0]
    x = torch.arange(xw, device=seq.device)
    pos = start[:, None] + sign * x[None, :]
    oob = (pos < 0) | (pos >= n)
    raw = torch.where(oob, 0, seq[pos.clamp(0, n - 1)])
    mapped = torch.where(raw < 2, 0, torch.where(raw <= 5, raw - 1, raw - 5))
    return raw, mapped


def max_ext_of(raw):
    """Boundary offset: the last offset before the first blocked character
    at x >= 1, or BIG (reference: gapped_extension.cpp:111-134)."""
    blocked = raw[:, 1:] < 2
    x = torch.arange(1, raw.shape[1], device=raw.device)
    first = torch.where(blocked, x, BIG).min(1).values
    return torch.where(blocked.any(1), first - 1, BIG)


def _seq_prefix(inc):
    """Sequential prefix chain: out[:, 0] = 0, out[:, x] = out[:, x-1] +
    inc[:, x] (reference gapped_extension.cpp:156-212 adds one entry at a
    time)."""
    out = torch.zeros_like(inc)
    c = out[:, 0]
    for x in range(1, inc.shape[1]):
        c = c + inc[:, x]
        out[:, x] = c
    return out


def _extend_dir(q_start, db_start, id_anchor, energy0, acc0, valid,
                qb, qab, dbb, aoff, coff, q_enc, db_seq, q_acc, q_cond,
                db_acc, db_cond, *, flag: int, d: int, dropout: int,
                min_helix: int, max_ext: int, dtype: str = "float32"):
    """One direction (flag 0 = left, 1 = right) of the gapped extension for
    a batch of hits over flat buffers.

    q_start/db_start: the fixed extension origins in query-local /
    chunk-local coordinates (reference gapped_extension.cpp:88-98 — flag 0:
    hit start points; flag 1: hit end points). id_anchor: db-accessibility
    anchor (flag 0: dbseq_start + db_len - 1; flag 1: dbseq_start).
    energy0/acc0: the hit's current total and accessibility energies.
    qb/qab/dbb: per-hit base offsets into the flat encoded-query, flat
    query-accessibility and flat db-sequence buffers; aoff/coff: absolute
    offsets of the hit's db sequence's accessibility arrays. Returns
    per-hit argmin extension amounts (min_i on the query side, min_j on the
    db side; 0 = no improvement), updated energies, the traceback offset
    lists (tb_i/tb_j, in reference push order, 0-terminated), and an
    `overflow` flag for hits still active at max_ext.
    """
    if max_ext > 120:
        raise ValueError(
            f"max_ext={max_ext} > 120: packed predecessor coords need 14 "
            f"bits (ZW payload bits 16384/32768 would be corrupted)")
    dt = _DTYPES[dtype]
    dev = q_start.device
    r_np = _tables_np()
    tab = tables_from_numpy(_plane_tables(flag), dt, dev)
    B = q_start.shape[0]
    W = max_ext               # lane i of a diagonal
    ME1 = max_ext + 1
    XW = max_ext + max(min_helix, 2)  # char arrays cover offsets 0..XW-1
    Y = W + 1                 # db-offset range of reachable cells
    sign = -1 if flag == 0 else 1

    # --- per-hit character windows ([B, X])
    q_raw, qm = _gather_chars(q_enc, qb + q_start, sign, XW)
    db_raw, dm = _gather_chars(db_seq, dbb + db_start, sign, XW)
    maxq = max_ext_of(q_raw)
    maxd = max_ext_of(db_raw)

    # prefix accessibility arrays, extq[x] / extdb[x] = energy of extending
    # x positions (reference: gapped_extension.cpp:156-212). The length-1
    # entry is computed in float32 and widened, as in the reference.
    x1 = torch.arange(XW, device=dev)

    def g1(arr, idx):
        return arr[idx.clamp(0, arr.shape[0] - 1)]

    def inc3(a_, b_, c_):
        full = a_.to(dt) - b_.to(dt) + c_.to(dt)
        full[:, 1] = (a_[:, 1] - b_[:, 1] + c_[:, 1]).to(dt)
        return full

    if flag == 0:
        posq = (qab + q_start)[:, None] - x1[None, :]
        incq = inc3(g1(q_acc, posq), g1(q_acc, posq + 1),
                    g1(q_cond, posq + d))
        incdb = g1(db_cond, (coff + id_anchor)[:, None] + x1[None, :]).to(dt)
    else:
        incq = g1(q_cond, (qab + q_start)[:, None] + x1[None, :]).to(dt)
        posd = (aoff + id_anchor)[:, None] - x1[None, :]
        posc = (coff + id_anchor)[:, None] - x1[None, :]
        incdb = inc3(g1(db_acc, posd), g1(db_acc, posd + 1),
                     g1(db_cond, posc + d))
    extq = _seq_prefix(incq)
    extdb = _seq_prefix(incdb)

    # --- planes: diagonal row D, lane i = cell (x, y) = (i, D - i); lanes
    # with i > D hold the y = 0 value and are never read by the sweep
    ydiag = (torch.arange(ME1, device=dev)[:, None]
             - torch.arange(W, device=dev)[None, :]).clamp(0, Y - 1)

    def qs(k):
        # qm[x + k] over x in [0, W) (0 where x + k < 0)
        if k >= 0:
            return qm[:, k: k + W]
        return torch.nn.functional.pad(qm[:, : W + k], (-k, 0))

    def ds(k):
        # dm[y + k] over y in [0, Y) (0 where y + k < 0)
        if k >= 0:
            return dm[:, k: k + Y]
        return torch.nn.functional.pad(dm[:, : Y + k], (-k, 0))

    def plane(M, qidx, didx, tb=None):
        """P[b, D, i] = M[(tb,) qidx[b, i], didx[b, D - i]]."""
        dd = didx[:, ydiag]
        if tb is None:
            return M[qidx[:, None, :], dd]
        return M[tb, qidx[:, None, :], dd]

    def pairq(k):
        return qs(0) * 5 + qs(k)

    def paird(k):
        return ds(0) * 5 + ds(k)

    q3 = pairq(-1) * 5 + qs(-2)
    d3 = paird(-1) * 5 + ds(-2)

    def tbp(qo, do):
        # stored type at (x - qo, y - do)
        return plane(tab["STT"], qs(-qo), ds(-do))

    # a device-tensor divisor keeps true division on CUDA (a Python-scalar
    # divisor is turned into a multiply by its reciprocal there)
    hundred = torch.tensor(100.0, dtype=dt, device=dev)
    F = torch.empty((B, sweep_op.N_FPLANES, ME1, W), dtype=dt, device=dev)
    sp = sweep_op.SPECIAL
    F[:, sweep_op.MS] = plane(tab["MS"], pairq(-1), paird(-1))
    F[:, sp[0, 0]] = plane(tab["STK00"], pairq(-1), paird(-1)) / hundred
    F[:, sp[1, 0]] = plane(tab["STK10"], pairq(-2), paird(-1)) / hundred
    F[:, sp[0, 1]] = plane(tab["STK01"], pairq(-1), paird(-2)) / hundred
    F[:, sp[1, 1]] = plane(tab["V11"], q3, d3) / hundred
    F[:, sp[1, 2]] = plane(tab["V12"], pairq(-1), d3, tbp(2, 3)) / hundred
    F[:, sp[2, 1]] = plane(tab["V21"], q3, paird(-1), tbp(3, 2)) / hundred
    F[:, sp[2, 2]] = plane(tab["V22"], q3, d3, tbp(3, 3)) / hundred
    F[:, sweep_op.VM] = plane(tab["VM"], pairq(1), paird(1))

    # bit planes of the flag-adjusted cell type; helix lookahead pairs
    # (qm[x+x'], dm[y+x']): both strands advance in the extension direction
    if min_helix >= 2:
        bad = plane(tab["BAD1"], pairq(1), paird(1))
    else:
        bad = torch.zeros((B, ME1, W), dtype=torch.int64, device=dev)
    for x2 in range(2, min_helix):
        bad = torch.maximum(bad, plane(tab["BADX"], qs(x2), ds(x2)))
    bits = (plane(tab["NZ0"], qs(0), ds(0)) * sweep_op.NZ0
            + plane(tab["W0"], qs(0), ds(0)) * sweep_op.W0
            + plane(tab["AU0"], qs(0), ds(0)) * sweep_op.AU0
            + bad * sweep_op.BAD).to(torch.int32)

    # --- origin cell (reference: gapped_extension.cpp:116-127)
    bp_t = torch.as_tensor(r_np["bp"], device=dev)
    rt_t = torch.as_tensor(r_np["rtype"], device=dev)
    otype = bp_t[qm[:, 0] * 5 + dm[:, 0]]
    if flag == 0:
        otype = rt_t[otype]
    obits = (otype == 0).long() + ((otype == 3) | (otype == 4)).long() * 2
    hit_i = torch.stack([maxq.clamp(max=BIG), maxd.clamp(max=BIG),
                         valid.long(), obits], 1).to(torch.int32)
    hit_f = torch.stack([energy0.to(dt), acc0.to(dt)], 1)
    consts = torch.tensor(
        [[float(r_np["intloop"][min(s, 30)]) for s in range(dropout + 1)],
         [_bulge_const(s) if s >= 2 else 0.0 for s in range(dropout + 1)]],
        dtype=dt, device=dev)

    pred, ints, floats = sweep_op.gapped_sweep(
        F, bits, extq.contiguous(), extdb.contiguous(), hit_i, hit_f,
        consts, float(r_np["term_au"]), dropout=dropout, max_ext=max_ext)
    min_i, min_j = ints[:, 0].long(), ints[:, 1].long()

    # --- traceback (reference: gapped_extension.cpp:409-424): walk the
    # predecessor links from (min_i, min_j); every step decreases the
    # diagonal by >= 2, so max_ext // 2 + 1 steps always reach the origin.
    pred_flat = pred.reshape(B, ME1 * W)
    steps = max_ext // 2 + 1
    tb_i = torch.zeros((B, steps), dtype=torch.int64, device=dev)
    tb_j = torch.zeros_like(tb_i)
    ti, tj = min_i, min_j
    for k in range(steps):
        live = (ti != 0) & (tj != 0)
        idx = ((ti + tj) * W + ti).clamp(0, ME1 * W - 1)
        packed = pred_flat.gather(1, idx[:, None])[:, 0].long().clamp(min=0)
        tb_i[:, k] = torch.where(live, ti, 0)
        tb_j[:, k] = torch.where(live, tj, 0)
        ti = torch.where(live, packed // ME1, 0)
        tj = torch.where(live, packed % ME1, 0)
    return dict(min_i=min_i, min_j=min_j, min_e=floats[:, 0],
                min_a=floats[:, 1], overflow=ints[:, 3] != 0,
                tb_i=tb_i, tb_j=tb_j)


def gapped_extend_both(cols: dict, energy, acc_e, valid, qbufs, dbufs, *,
                       d: int, dropout: int, min_helix: int, max_ext: int,
                       dtype: str = "float32"):
    """Both extension directions: left, then right from the post-left
    extents (reference gapped_extension.cpp:41-47). cols: int64 [B]
    tensors q_sp, db_sp, q_len, db_len, dbseq_start, qb, qab, dbb, aoff,
    coff. Returns (ints [B, 4] = min_i/j of each direction, floats [B, 2] =
    final energy/acc, overflow [B], tb [B, 4, T] = tb_i0, tb_j0, tb_i1,
    tb_j1)."""
    seqs = (qbufs[0], dbufs[0], qbufs[1], qbufs[2], dbufs[1], dbufs[2])
    bases = tuple(cols[k] for k in ("qb", "qab", "dbb", "aoff", "coff"))
    kw = dict(d=d, dropout=dropout, min_helix=min_helix, max_ext=max_ext,
              dtype=dtype)
    r0 = _extend_dir(cols["q_sp"], cols["db_sp"],
                     cols["dbseq_start"] + cols["db_len"] - 1,
                     energy, acc_e, valid, *bases, *seqs, flag=0, **kw)
    q_sp2 = cols["q_sp"] - r0["min_i"]
    db_sp2 = cols["db_sp"] - r0["min_j"]
    q_end2 = q_sp2 + (cols["q_len"] + r0["min_i"]) - 1
    db_end2 = db_sp2 + (cols["db_len"] + r0["min_j"]) - 1
    r1 = _extend_dir(q_end2, db_end2, cols["dbseq_start"],
                     r0["min_e"], r0["min_a"], valid, *bases, *seqs,
                     flag=1, **kw)
    ints = torch.stack([r0["min_i"], r0["min_j"], r1["min_i"],
                        r1["min_j"]], 1)
    floats = torch.stack([r1["min_e"], r1["min_a"]], 1)
    tb = torch.stack([r0["tb_i"], r0["tb_j"], r1["tb_i"], r1["tb_j"]], 1)
    return ints, floats, r0["overflow"] | r1["overflow"], tb


_HI_COLS = ("q_sp", "db_sp", "q_len", "db_len", "dbseq_start",
            "qb", "qab", "dbb", "aoff", "coff")


def gapped_extend_flat_batch(hits, qbufs, dbufs, *, d: int, dropout: int,
                             min_helix: int, max_ext: int = 64,
                             dtype: str = "float32", device):
    """Both extension directions for a hit batch (SoA numpy dict carrying
    per-hit base offsets qb/qab/dbb/aoff/coff): device DP + device
    traceback. Returns (updated hit dict, bp dict, overflow mask). The bp
    dict holds the gapped base pairs in reference push order as flat
    arrays: n0/q0/db0 for the left extension (per-hit counts + coords) and
    n1/q1/db1 for the right. Hits flagged overflow are NOT extended here —
    the caller re-runs them on the host engine from their pre-extension
    state. qbufs = (q_enc, q_acc, q_cond) and dbufs = (db_seq, db_acc,
    db_cond) are flat device tensors; reference: gapped_extension.cpp:41-67.
    """
    n = len(hits["q_sp"])
    cols = {k: torch.as_tensor(np.asarray(hits[k], np.int64), device=device)
            for k in _HI_COLS}
    energy = torch.as_tensor(np.asarray(hits["energy"], np.float64),
                             device=device)
    acc_e = torch.as_tensor(np.asarray(hits["acc_e"], np.float64),
                            device=device)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    ints, floats, ovf, tb = gapped_extend_both(
        cols, energy, acc_e, valid, qbufs, dbufs, d=d, dropout=dropout,
        min_helix=min_helix, max_ext=max_ext, dtype=dtype)
    ints = ints.cpu().numpy().astype(np.int32)
    floats = floats.cpu().numpy()
    tb = tb.cpu().numpy().astype(np.int32)
    overflow = ovf.cpu().numpy()
    m_i0, m_j0, m_i1, m_j1 = (ints[:, k] for k in range(4))
    q_sp = np.asarray(hits["q_sp"]).astype(np.int32)
    db_sp = np.asarray(hits["db_sp"]).astype(np.int32)
    q_sp2 = q_sp - m_i0
    db_sp2 = db_sp - m_j0
    q_len2 = np.asarray(hits["q_len"]).astype(np.int32) + m_i0
    db_len2 = np.asarray(hits["db_len"]).astype(np.int32) + m_j0

    def coords(tb_i, tb_j, q0, db0, sgn):
        """Vectorized traceback coordinates in push order."""
        mask = (tb_i > 0) & (tb_j > 0)
        cq = (q0[:, None] + sgn * tb_i)[mask]
        cdb = (db0[:, None] + sgn * tb_j)[mask]
        return dict(n=mask.sum(axis=1).astype(np.int64),
                    q=cq.astype(np.int32), db=cdb.astype(np.int32))

    bp0 = coords(tb[:, 0], tb[:, 1], q_sp, db_sp, -1)
    bp1 = coords(tb[:, 2], tb[:, 3], q_sp2 + q_len2 - 1,
                 db_sp2 + db_len2 - 1, 1)

    out = dict(hits)
    out["q_sp"] = q_sp2
    out["db_sp"] = db_sp2
    out["q_len"] = q_len2 + m_i1
    out["db_len"] = db_len2 + m_j1
    out["dbseq_start"] = (np.asarray(hits["dbseq_start"]).astype(np.int32)
                          - m_j1)
    out["energy"] = floats[:, 0].astype(np.float64)
    out["acc_e"] = floats[:, 1].astype(np.float64)
    out["hyb_e"] = out["energy"] - out["acc_e"]
    bps = dict(n0=bp0["n"], q0=bp0["q"], db0=bp0["db"],
               n1=bp1["n"], q1=bp1["q"], db1=bp1["db"])
    return out, bps, overflow
