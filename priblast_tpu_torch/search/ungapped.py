"""Batched ungapped extension over flat buffers: the plain PyTorch version
of the CUDA kernel csrc/ungapped_extend.cu (wrapper:
ops/ungapped_extend.py, which calls this function for CPU tensors).

The per-hit left/right greedy extension scans of the reference
(src/ungapped_extension.cpp:30-155) run as lockstep batched loops over a
whole hit batch: each step advances every still-active hit one position,
with per-hit gathers from the encoded sequences and accessibility arrays
and packed-index lookups into the raw Turner tables. Arithmetic follows
the reference: float32 accessibility steps and energies, running minimum
with its argmin.

Hits are batched ACROSS queries and db chunks: every query/chunk sequence
and accessibility array lives in one flat device buffer, and each hit
carries base offsets (qb / qab / dbb / aoff / coff) into those buffers.
Hit coordinates stay local to their query / chunk, as in the reference.
A zero pad byte precedes every region, so the reference's left-boundary
stop (sentinel or i < 0) falls out of the same `char < 2` test.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from priblast_tpu_torch.utils import thermo


@functools.lru_cache(maxsize=1)
def _tables_np():
    r = thermo.RAW
    f = lambda x: np.asarray(x, np.float32).reshape(-1)  # noqa: E731
    return dict(
        bp=r.BP_pair.reshape(-1).astype(np.int64),
        rtype=r.rtype.astype(np.int64),
        stack=f(r.stack37),
        i11=f(r.int11_37),
        i21=f(r.int21_37),
        i22=f(r.int22_37),
        mismI=f(r.mismatchI37),
        intloop=f(r.internal_loop37),
    )


def _tables(device):
    t = {k: torch.as_tensor(v, device=device)
         for k, v in _tables_np().items()}
    t["hundred"] = torch.tensor(100.0, dtype=torch.float32, device=device)
    return t


def _at(buf, pos):
    return buf[pos.clamp(0, buf.shape[0] - 1)]


def _take(tab, idx):
    # the index is only meaningful where the caller uses the result; clamp
    # so masked-off lanes never read out of bounds
    return tab[idx.clamp(0, tab.shape[0] - 1)]


def _mapc(v):
    # encoded char -> energy index (2..5 -> 1..4; soft-masked 6..9 -> 1..4)
    return torch.where(v <= 5, v - 1, v - 5)


def _loop37(t, qbuf, dbuf, type1, type2, fi, fj, fp, fq, u1, u2):
    """Hybridization loop energy on raw tables / 100 (no-bulge variant;
    reference: src/ungapped_extension.cpp:157-186). fi/fj/fp/fq are flat
    buffer positions of the outer (i, j) and inner (p, q) pairs."""
    a = _mapc(_at(qbuf, fi + 1))
    b = _mapc(_at(dbuf, fj + 1))
    c = _mapc(_at(qbuf, fp - 1))
    dch = _mapc(_at(dbuf, fq - 1))

    z_stack = _take(t["stack"], type1 * 7 + type2)
    z11 = _take(t["i11"], ((type1 * 8 + type2) * 5 + a) * 5 + b)
    z12 = _take(t["i21"], (((type1 * 8 + type2) * 5 + a) * 5 + dch) * 5 + b)
    z21 = _take(t["i21"], (((type2 * 8 + type1) * 5 + dch) * 5 + a) * 5 + c)
    z22 = _take(t["i22"],
                ((((type1 * 8 + type2) * 5 + a) * 5 + c) * 5 + dch) * 5 + b)
    zgen = (_take(t["intloop"], (u1 + u2).clamp(0, 30))
            + _take(t["mismI"], (type1 * 5 + a) * 5 + b)
            + _take(t["mismI"], (type2 * 5 + dch) * 5 + c))

    both0 = (u1 == 0) & (u2 == 0)
    z = torch.where(both0, z_stack,
        torch.where(u1 + u2 == 2, z11,                              # noqa
        torch.where((u1 == 1) & (u2 == 2), z12,                     # noqa
        torch.where((u1 == 2) & (u2 == 1), z21,                     # noqa
        torch.where((u1 == 2) & (u2 == 2), z22, zgen)))))           # noqa
    # a device-tensor divisor keeps true division on CUDA (a Python-scalar
    # divisor is turned into a multiply by its reciprocal there)
    return z / t["hundred"]


def ungapped_extend_flat(q_sp, db_sp, length, dbseq_start, acc_e, hyb_e,
                         qb, qab, dbb, aoff, coff, bufs, dbufs, d: int,
                         dropout: int):
    """Extend a batch of hits over flat buffers.

    Per-hit tensors (all [B], int64 positions, float32 energies):
      q_sp/db_sp/length/dbseq_start — hit extent in query-local /
        chunk-local coordinates (reference Hit fields, src/hit.hpp:38-118);
      acc_e/hyb_e — seed energies;
      qb/qab — the query's base offsets into the flat encoded / flat
        accessibility buffers; dbb — chunk base into the flat db sequence
        buffer; aoff/coff — absolute offsets of the hit's db sequence's
        accessibility arrays.
    bufs = (q_enc_flat, q_acc_flat, q_cond_flat);
    dbufs = (db_seq_flat, db_acc_flat, db_cond_flat).
    Returns a dict of [B] tensors: q_sp, db_sp, q_len, db_len (one
    tensor), dbseq_start, acc_e, hyb_e, energy.
    """
    return _extend(q_sp, db_sp, length, dbseq_start, acc_e, hyb_e, qb, qab,
                   dbb, aoff, coff, bufs, dbufs, d, dropout)[0]


def extend_steps(*args):
    """The steps each phase of `ungapped_extend_flat(*args)` takes past its
    start, per hit: (left, right) int64 [B], the kernel's work per hit."""
    return _extend(*args)[1:]


def _extend(q_sp, db_sp, length, dbseq_start, acc_e, hyb_e, qb, qab, dbb,
            aoff, coff, bufs, dbufs, d: int, dropout: int):
    """`ungapped_extend_flat`'s dict, and the left and right step counts."""
    t = _tables(q_sp.device)
    qbuf, q_acc, q_cond = bufs
    dbuf, db_acc, db_cond = dbufs
    bp, rt = t["bp"], t["rtype"]
    zero = torch.zeros((), dtype=torch.float32, device=q_sp.device)

    energy0 = acc_e + hyb_e
    acc_e = acc_e.clone()
    hyb_e = hyb_e.clone()

    def pair_type(qi, di):
        return _take(bp, _mapc(_at(qbuf, qb + qi)) * 5
                     + _mapc(_at(dbuf, dbb + di)))

    # ---- left phase (reference :55-94) ----
    i, j = q_sp.clone(), db_sp.clone()
    id_end = dbseq_start + length - 1
    p, q = q_sp.clone(), db_sp.clone()
    e, a, hh = energy0.clone(), acc_e.clone(), hyb_e.clone()
    min_e, min_a, min_h = energy0.clone(), acc_e.clone(), hyb_e.clone()
    min_p, min_q = q_sp.clone(), db_sp.clone()
    steps_l = torch.zeros_like(q_sp)
    active = torch.ones_like(q_sp, dtype=torch.bool)
    while bool(active.any()):
        i_n, j_n, id_n = i - 1, j - 1, id_end + 1
        brk = ((i_n < 0) | (j_n < 0) | (_at(qbuf, qb + i_n) < 2)
               | (_at(dbuf, dbb + j_n) < 2))
        act = active & ~brk
        steps_l += act

        dacc = (_at(q_acc, qab + i_n) - _at(q_acc, qab + i_n + 1)
                + _at(q_cond, qab + i_n + d) + _at(db_cond, coff + id_n))
        e = e + torch.where(act, dacc, zero)
        a = a + torch.where(act, dacc, zero)

        type1 = pair_type(i_n, j_n)
        type2 = _take(rt, pair_type(p, q))
        paired = act & (type1 != 0)
        le = _loop37(t, qbuf, dbuf, type1, type2, qb + i_n, dbb + j_n,
                     qb + p, dbb + q, p - i_n - 1, q - j_n - 1)
        le = torch.where(paired, le, zero)
        e = e + le
        hh = hh + le

        better = paired & (e < min_e)
        min_e = torch.where(better, e, min_e)
        min_a = torch.where(better, a, min_a)
        min_h = torch.where(better, hh, min_h)
        min_p = torch.where(better, i_n, min_p)
        min_q = torch.where(better, j_n, min_q)

        p = torch.where(paired, i_n, p)
        q = torch.where(paired, j_n, q)
        drop = (min_p - i_n) >= dropout
        i = torch.where(active, i_n, i)
        j = torch.where(active, j_n, j)
        id_end = torch.where(active, id_n, id_end)
        active = act & ~drop

    # ---- right phase (reference :96-145) ----
    k = q_sp + length - 1
    l = db_sp + length - 1                                        # noqa: E741
    ids = dbseq_start.clone()
    r, s = k.clone(), l.clone()
    e, a, hh = min_e.clone(), min_a.clone(), min_h.clone()
    min_r, min_ids = k.clone(), dbseq_start.clone()
    steps_r = torch.zeros_like(q_sp)
    active = torch.ones_like(q_sp, dtype=torch.bool)
    while bool(active.any()):
        k_n, l_n, ids_n = k + 1, l + 1, ids - 1
        brk = (_at(qbuf, qb + k_n) < 2) | (_at(dbuf, dbb + l_n) < 2)
        act = active & ~brk
        steps_r += act

        dacc = (_at(q_cond, qab + k_n) + _at(db_acc, aoff + ids_n)
                - _at(db_acc, aoff + ids_n + 1)
                + _at(db_cond, coff + ids_n + d))
        e = e + torch.where(act, dacc, zero)
        a = a + torch.where(act, dacc, zero)

        type2 = _take(rt, pair_type(k_n, l_n))
        type1 = pair_type(r, s)
        paired = act & (type2 != 0)
        le = _loop37(t, qbuf, dbuf, type1, type2, qb + r, dbb + s,
                     qb + k_n, dbb + l_n, k_n - r - 1, l_n - s - 1)
        le = torch.where(paired, le, zero)
        e = e + le
        hh = hh + le

        better = paired & (e < min_e)
        min_e = torch.where(better, e, min_e)
        min_a = torch.where(better, a, min_a)
        min_h = torch.where(better, hh, min_h)
        min_r = torch.where(better, k_n, min_r)
        min_ids = torch.where(better, ids_n, min_ids)

        r = torch.where(paired, k_n, r)
        s = torch.where(paired, l_n, s)
        drop = (k_n - min_r) >= dropout
        k = torch.where(active, k_n, k)
        l = torch.where(active, l_n, l)                           # noqa: E741
        ids = torch.where(active, ids_n, ids)
        active = act & ~drop

    new_len = min_r - min_p + 1
    return dict(q_sp=min_p, db_sp=min_q, q_len=new_len, db_len=new_len,
                dbseq_start=min_ids, acc_e=min_a, hyb_e=min_h,
                energy=min_e), steps_l, steps_r
