"""Batched gapped extension on the device (PyTorch), over flat buffers.

Reference semantics: src/gapped_extension.cpp:33-319 (mirrored by the
native host engine, ops/native/search.cc gapped_extend_one). The
reference's pruned stem-candidate list (CheckStemCandidate,
gapped_extension.cpp:213-217) only admits predecessors whose interior loop
size u1+u2 = (i-k-1)+(j-l-1) is <= dropout, so the DP is a *banded*
anti-diagonal sweep: each diagonal L evaluates all cells (i, L-i) as a min
over the (dropout+1)(dropout+2)/2 static (u1,u2) predecessor offsets.

One direction (`_extend_dir`) is one call of
ops/gapped_sweep.py:gapped_extend_dir: on the card one CUDA kernel from
the characters to the traceback, on the CPU its plain version (energy
planes, the sweep, the traceback walk). Extension is capped at `max_ext`
diagonals; hits still active at the cap are flagged `overflow` and the
caller re-runs them from their pre-extension state on the host engine.
"""

from __future__ import annotations

import numpy as np
import torch

from priblast_tpu_torch.ops import gapped_sweep as sweep_op
# the plane tables of the plain version, importable from here as before
from priblast_tpu_torch.ops.gapped_sweep import (  # noqa: F401
    _plane_tables, tables_from_numpy)
from priblast_tpu_torch.utils import profiling as prof


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
    lists (tb_i/tb_j int32, in reference push order, 0-terminated), and an
    `overflow` flag for hits still active at max_ext.
    """
    ints, floats, tb = sweep_op.gapped_extend_dir(
        q_start, db_start, id_anchor, energy0, acc0, valid, qb, qab, dbb,
        aoff, coff, q_enc, db_seq, q_acc, q_cond, db_acc, db_cond,
        flag=flag, d=d, dropout=dropout, min_helix=min_helix,
        max_ext=max_ext, dtype=dtype)
    return dict(min_i=ints[:, 0].long(), min_j=ints[:, 1].long(),
                min_e=floats[:, 0], min_a=floats[:, 1],
                overflow=ints[:, 3] != 0, tb_i=tb[:, 0], tb_j=tb[:, 1])


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
                             min_helix: int, max_ext: int = 32,
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
    prof.count("ris.gapped.d2h_bytes",
               ints.nbytes + floats.nbytes + tb.nbytes + ovf.nbytes)
    with prof.stage("ris.gapped.fetch"):
        ints, floats, tb, overflow = (t.cpu().numpy()
                                      for t in (ints, floats, tb, ovf))
    ints = ints.astype(np.int32)
    tb = tb.astype(np.int32)
    prof.count("ris.gapped.hits", n)
    prof.count("ris.gapped.overflow", int(overflow.sum()))
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
