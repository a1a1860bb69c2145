"""The plain reference of one `ris` search: one query against one target.

RIblast's search (seed, interaction-energy expansion, ungapped extension,
redundancy removal, gapped extension with dangles, final redundancy
removal; the reference binary's src/seed_search.cpp,
src/ungapped_extension.cpp, src/gapped_extension.cpp and
src/rna_interaction_search.cpp) written out in numpy and plain Python
for one (query, target) pair. A page's hits for one target do not depend
on the page's other targets: seeds are matches of the two strings, every
extension stops at the target's sentinel and the redundancy removal
compares hits of one target only (a hit of another target ends before or
starts after it). So the lines a page search prints for a query and one
of its targets are this function's hits for that pair.

Inputs are plain strings and the accessibility energies worked out by
`raccess.LinearRaccess` (float32, as the db files store them). Energies
in kcal/mol; float32 steps where the reference computes in float. With
`p["round"] = bfloat16` every energy the search accumulates is rounded to
bfloat16: the check's control.
"""

from __future__ import annotations

import numpy as np

from . import thermo

POS_INF = 1000000.0
MAX_EXT = 100000  # the reference's MAX_EXTENSION

_CODE = np.zeros(256, np.uint8) + 1
for _c, _v in zip(b"ACGTU", (2, 3, 4, 5, 5)):
    _CODE[_c] = _v


class Tables:
    """The integer energy tables (10 cal/mol) of the hybridization model."""

    def __init__(self):
        r = thermo.RAW
        self.bp = r.BP_pair.astype(np.int64)
        self.rtype = r.rtype.astype(np.int64)
        self.stack = r.stack37.astype(np.float64)
        self.mism_i = r.mismatchI37.astype(np.float64)
        self.int11 = r.int11_37.astype(np.float64)
        self.int21 = r.int21_37.astype(np.float64)
        self.int22 = r.int22_37.astype(np.float64)
        self.internal = r.internal_loop37.astype(np.float64)
        self.bulge = r.bulge37.astype(np.float64)
        self.dangle5 = r.dangle5_37.astype(np.float64)
        self.dangle3 = r.dangle3_37.astype(np.float64)
        self.term_au = float(r.TerminalAU)
        self.lxc = thermo.LXC37
        # search code (0..9) -> base 0..4 (A=1 .. U=4), sentinel and
        # unknown -> 0
        self.base = np.array([0, 0, 1, 2, 3, 4, 1, 2, 3, 4], np.int64)


_T = None


def tables() -> Tables:
    global _T
    if _T is None:
        _T = Tables()
    return _T


def encode_query(seq: str) -> np.ndarray:
    """Forward search codes (A 2, C 3, G 4, U 5) with one 0 sentinel."""
    raw = np.frombuffer(seq.encode("ascii"), np.uint8)
    return np.concatenate([_CODE[raw], [0]]).astype(np.int64)


def encode_target(seq: str) -> np.ndarray:
    """Reversed search codes with one 0 sentinel."""
    raw = np.frombuffer(seq.encode("ascii"), np.uint8)[::-1]
    return np.concatenate([_CODE[raw], [0]]).astype(np.int64)


def _c(seq, i):
    """The base at i, 0 off either end or at a sentinel."""
    if i < 0 or i >= len(seq) or seq[i] < 2:
        return 0
    return int(_T.base[seq[i]])


def _window_access(acc, cond, sp, length, d, rd):
    t = rd(float(acc[sp]))
    for i in range(d, length):
        t = rd(t + float(cond[sp + i]))
    return t


def _f32(x):
    return np.float32(x)


def exact(x):
    """The reference's own arithmetic: no rounding."""
    return x


def bfloat16(x):
    """x rounded to bfloat16 (nearest, ties to even), as a Python float
    or a float64 array: the arithmetic of the check's control, the
    reference computed in the precision below the configuration's."""
    a = np.asarray(x, np.float64).astype(np.float32)
    b = np.atleast_1d(a).view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    r = b.view(np.float32).astype(np.float64).reshape(a.shape)
    return float(r) if r.ndim == 0 else r


# ---------------------------------------------------------------- seeds

# stem pairs (query code, target code) in the reference's search order
_STEM = ((3, 4), (4, 3), (4, 5), (5, 4), (2, 5), (5, 2))


def seeds(q, t, p):
    """Every seed: for each start pair (i, j) the first length L >=
    min_acc_len at which the stacked pairs q[i..i+L) : t[j..j+L) reach
    a hybridization energy below the hybrid threshold, L <= the longest
    seed. Returns arrays (i, j, L, energy)."""
    T = tables()
    rd = p.get("round", exact)
    ok = np.zeros((10, 10), bool)
    for a, b in _STEM:
        ok[a, b] = True
    typ = T.bp[T.base[:, None], T.base[None, :]]  # [qcode, tcode]
    nq, nt = len(q), len(t)
    out = []
    for lo in range(0, nq, 256):
        qi = np.arange(lo, min(nq, lo + 256))
        ii, jj = np.meshgrid(qi, np.arange(nt), indexing="ij")
        ii, jj = ii.ravel(), jj.ravel()
        live = ok[q[ii], t[jj]]
        ii, jj = ii[live], jj[live]
        sc = np.zeros(len(ii))
        prev = typ[q[ii], t[jj]]
        for k in range(1, p["max_seed_length"]):
            qa, ta = ii + k, jj + k
            inb = (qa < nq) & (ta < nt)
            qa, ta = np.minimum(qa, nq - 1), np.minimum(ta, nt - 1)
            live = inb & ok[q[qa], t[ta]]
            ii, jj, sc, prev = ii[live], jj[live], sc[live], prev[live]
            qa, ta = qa[live], ta[live]
            cur = typ[q[qa], t[ta]]
            sc = rd(sc + T.stack[prev, T.rtype[cur]] / 100)
            prev = cur
            emit = (sc < p["hybrid_thr"]) & (k + 1 >= p["min_acc_len"])
            if emit.any():
                out.append((ii[emit], jj[emit],
                            np.full(int(emit.sum()), k + 1), sc[emit]))
            ii, jj, sc, prev = ii[~emit], jj[~emit], sc[~emit], prev[~emit]
            if len(ii) == 0:
                break
    if not out:
        z = np.zeros(0, np.int64)
        return z, z, z, np.zeros(0)
    return tuple(np.concatenate([o[f] for o in out]) for f in range(4))


# ---------------------------------------------------------------- hits

class Hit:
    __slots__ = ("q_sp", "db_sp", "q_len", "db_len", "start", "acc_e",
                 "hyb_e", "energy", "flag", "bps")

    def __init__(self, q_sp, db_sp, length, start, acc_e, hyb_e):
        self.q_sp, self.db_sp = q_sp, db_sp
        self.q_len = self.db_len = length
        self.start = start  # window start on the target, forward
        self.acc_e, self.hyb_e = acc_e, hyb_e
        self.energy = acc_e + hyb_e
        self.flag = False
        self.bps = []

    def key(self):
        return (self.db_sp, self.q_sp, -self.db_len, -self.q_len)


def _loop(type1, type2, i, j, pp, qq, q, t, bulges):
    """Loop energy (kcal/mol) between the pair (i, j) and the next pair
    (pp, qq) of a duplex; with `bulges`, loops open on one side only
    count as bulges."""
    T = _T
    u1, u2 = pp - i - 1, qq - j - 1
    if u1 == 0 and u2 == 0:
        z = T.stack[type1, type2]
    elif bulges and (u1 == 0 or u2 == 0):
        u = u2 if u1 == 0 else u1
        z = T.bulge[u] if u <= 30 else T.bulge[30] + T.lxc * np.log(u / 30.0)
        if u == 1:
            z += T.stack[type1, type2]
        else:
            if type1 > 2:
                z += T.term_au
            if type2 > 2:
                z += T.term_au
    else:
        a, b = _c(q, i + 1), _c(t, j + 1)
        c, d = _c(q, pp - 1), _c(t, qq - 1)
        if u1 + u2 == 2:
            z = T.int11[type1, type2, a, b]
        elif u1 == 1 and u2 == 2:
            z = T.int21[type1, type2, a, d, b]
        elif u1 == 2 and u2 == 1:
            z = T.int21[type2, type1, d, a, c]
        elif u1 == 2 and u2 == 2:
            z = T.int22[type1, type2, a, c, d, b]
        else:
            z = (T.internal[u1 + u2] + T.mism_i[type1, a, b]
                 + T.mism_i[type2, d, c])
    return float(z) / 100.0


def _pair(q, t, i, j):
    return int(_T.bp[_c(q, i), _c(t, j)])


def ungapped(h, q, t, qacc, qcond, tacc, tcond, p):
    d = p["min_acc_len"]
    rd = p.get("round", exact)
    T = _T
    min_e = e = h.energy
    min_a = a = h.acc_e
    min_h = hh = h.hyb_e
    i = pp = h.q_sp
    j = qq = h.db_sp
    min_p, id_end = pp, h.start + h.db_len - 1
    id_start = min_id_start = h.start
    while True:
        i -= 1
        j -= 1
        id_end += 1
        if i < 0 or j < 0 or q[i] < 2 or t[j] < 2:
            break
        step = float(_f32(_f32(_f32(qacc[i] - qacc[i + 1]) + qcond[i + d])
                          + tcond[id_end]))
        e = rd(e + step)
        a = rd(a + step)
        type1 = _pair(q, t, i, j)
        if type1 != 0:
            type2 = int(T.rtype[_pair(q, t, pp, qq)])
            le = _loop(type1, type2, i, j, pp, qq, q, t, False)
            e = rd(e + le)
            hh = rd(hh + le)
            if e < min_e:
                min_e, min_a, min_h, min_p = e, a, hh, i
            pp, qq = i, j
        if min_p - i >= p["dropout_wo_gap"]:
            break
    min_q = h.db_sp - (h.q_sp - min_p)
    e, a, hh = min_e, min_a, min_h
    k = r = h.q_sp + h.q_len - 1
    l = s = h.db_sp + h.q_len - 1
    min_r = r
    while True:
        k += 1
        l += 1
        id_start -= 1
        if q[k] < 2 or t[l] < 2:
            break
        step = float(_f32(_f32(_f32(qcond[k] + tacc[id_start])
                               - tacc[id_start + 1]) + tcond[id_start + d]))
        e = rd(e + step)
        a = rd(a + step)
        type2 = int(T.rtype[_pair(q, t, k, l)])
        if type2 != 0:
            type1 = _pair(q, t, r, s)
            le = _loop(type1, type2, r, s, k, l, q, t, False)
            e = rd(e + le)
            hh = rd(hh + le)
            if e < min_e:
                min_e, min_a, min_h, min_r = e, a, hh, k
                min_id_start = id_start
            r, s = k, l
        if k - min_r >= p["dropout_wo_gap"]:
            break
    h.start = min_id_start
    h.q_sp, h.db_sp = min_p, min_q
    h.q_len = h.db_len = min_r - min_p + 1
    h.energy, h.acc_e, h.hyb_e = min_e, min_a, min_h


def drop_redundant(hits, thr):
    n = len(hits)
    for x in range(n):
        a = hits[x]
        if a.energy > thr:
            a.flag = True
        if a.flag:
            continue
        a_qep = a.q_sp + a.q_len - 1
        a_dbep = a.db_sp + a.db_len - 1
        for y in range(x + 1, n):
            b = hits[y]
            if b.flag:
                continue
            if a_dbep < b.db_sp:
                break
            if (a_qep >= b.q_sp + b.q_len - 1 and a.q_sp <= b.q_sp
                    and a_dbep >= b.db_sp + b.db_len - 1):
                if a.energy > b.energy:
                    a.flag = True
                else:
                    b.flag = True
    return [h for h in hits if not h.flag]


def _wobble(tp):
    return tp == 3 or tp == 4


def gapped(h, q, t, qacc, qcond, tacc, tcond, p, flag):
    T = _T
    rd = p.get("round", exact)
    d = p["min_acc_len"]
    dropout = p["dropout_w_gap"]
    min_energy = h.energy
    first_a = min_a = h.acc_e
    if flag == 0:
        q0, t0 = h.q_sp, h.db_sp
    else:
        q0, t0 = h.q_sp + h.q_len - 1, h.db_sp + h.db_len - 1
    sgn = -1 if flag == 0 else 1
    max_q = max_t = MAX_EXT
    id_start0 = h.start
    id_end0 = id_start0 + h.db_len - 1
    min_q0, min_t0 = q0, t0
    q_len0, db_len0 = h.q_len, h.db_len
    min_q_len, min_db_len, min_id_start = q_len0, db_len0, id_start0
    length = min_length = 0

    def btype(i, j, x):
        tp = int(T.bp[_c(q, q0 + sgn * (i + x)), _c(t, t0 + sgn * (j + x))])
        return int(T.rtype[tp]) if flag == 1 else tp

    tp0 = int(T.bp[_c(q, q0), _c(t, t0)])
    if flag == 0:
        tp0 = int(T.rtype[tp0])
    cells = {(0, 0): (-1, -1, tp0, min_energy)}
    stems = [(0, 0, tp0)]
    ext_q, ext_t = [], []
    while True:
        length += 1
        if flag == 0:
            if max_q == MAX_EXT and (q0 - length < 0 or q[q0 - length] < 2):
                max_q = length - 1
            if max_t == MAX_EXT and (t0 - length < 0 or t[t0 - length] < 2):
                max_t = length - 1
        else:
            if max_q == MAX_EXT and q[q0 + length] < 2:
                max_q = length - 1
            if max_t == MAX_EXT and t[t0 + length] < 2:
                max_t = length - 1
        if flag == 0:
            if max_q == MAX_EXT:
                x = q0 - length
                if length == 1:
                    ext_q.append(rd(float(_f32(_f32(qacc[x] - qacc[x + 1])
                                               + qcond[x + d]))))
                else:
                    ext_q.append(rd(ext_q[-1] + float(qacc[x])
                                    - float(qacc[x + 1])
                                    + float(qcond[x + d])))
            if max_t == MAX_EXT:
                v = float(tcond[id_end0 + length])
                ext_t.append(rd(v if length == 1 else ext_t[-1] + v))
        else:
            if max_q == MAX_EXT:
                v = float(qcond[q0 + length])
                ext_q.append(rd(v if length == 1 else ext_q[-1] + v))
            if max_t == MAX_EXT:
                x = id_start0 - length
                if length == 1:
                    ext_t.append(rd(float(_f32(_f32(tacc[x] - tacc[x + 1])
                                               + tcond[x + d]))))
                else:
                    ext_t.append(rd(ext_t[-1] + float(tacc[x])
                                    - float(tacc[x + 1])
                                    + float(tcond[x + d])))
        if length - 2 > dropout:
            stems = [s for s in stems if length - s[0] - s[1] - 2 <= dropout]
        for i in range(1, length):
            j = length - i
            if i > max_q or j > max_t:
                continue
            type1 = btype(i, j, 0)
            if type1 != 0:
                prev = cells.get((i - 1, j - 1))
                if prev is None or prev[2] == 0 or (
                        _wobble(type1) and _wobble(prev[2])):
                    for x in range(1, p["min_helix"]):
                        tx = btype(i, j, x)
                        if tx == 0 or (x == 1 and _wobble(type1)
                                       and _wobble(tx)):
                            type1 = 0
                            break
            if type1 == 0:
                continue
            best, hybrid = 0, POS_INF
            for k, (sf, ss, st) in enumerate(stems):
                if sf < i and ss < j:
                    if flag == 0:
                        ce = _loop(type1, st, q0 - i, t0 - j, q0 - sf, t0 - ss,
                                   q, t, True)
                    else:
                        ce = _loop(st, type1, q0 + sf, t0 + ss, q0 + i, t0 + j,
                                   q, t, True)
                    ce = rd(ce + cells[(sf, ss)][3])
                    if ce < hybrid:
                        hybrid, best = ce, k
            sf, ss, st = stems[best]
            cells[(i, j)] = (sf, ss, st, hybrid)
            inter = rd(ext_q[i - 1] + ext_t[j - 1] + hybrid)
            stems.append((i, j, int(T.rtype[type1])))
            if inter < min_energy:
                min_energy = inter
                min_a = rd(first_a + ext_q[i - 1] + ext_t[j - 1])
                min_length = length
                if flag == 0:
                    min_q0, min_t0 = q0 - i, t0 - j
                else:
                    min_id_start = id_start0 - j
                min_q_len, min_db_len = q_len0 + i, db_len0 + j
        if length - min_length >= dropout:
            break
        if max_q != MAX_EXT and max_t != MAX_EXT:
            break
    if q_len0 != min_q_len and db_len0 != min_db_len:
        if flag == 0:
            ti, tj = q0 - min_q0, t0 - min_t0
        else:
            ti, tj = min_q_len - q_len0, min_db_len - db_len0
        while ti != 0 and tj != 0:
            h.bps.append((q0 + sgn * ti, t0 + sgn * tj))
            ti, tj = cells[(ti, tj)][0], cells[(ti, tj)][1]
    h.start = min_id_start
    if flag == 0:
        h.q_sp, h.db_sp = min_q0, min_t0
    h.q_len, h.db_len = min_q_len, min_db_len
    h.energy, h.acc_e = min_energy, min_a
    h.hyb_e = rd(min_energy - min_a)


def _dangle(q, t, qpos, tpos, flag):
    T = _T
    qc, tc = _c(q, qpos), _c(t, tpos)
    tp = int(T.bp[qc, tc] if flag == 0 else T.bp[tc, qc])
    x = 0.0
    if tp != 0:
        if flag == 0:
            if qpos > 0:
                x += T.dangle5[tp, _c(q, qpos - 1)]
            if tpos > 0 and t[tpos - 1] != 0:
                x += T.dangle3[tp, _c(t, tpos - 1)]
            if (tpos == 0 or t[tpos - 1] == 0) and tp > 2:
                x += T.term_au
        else:
            if tpos < len(t) - 1 and t[tpos + 1] != 0:
                x += T.dangle5[tp, _c(t, tpos + 1)]
            if qpos < len(q) - 2:
                x += T.dangle3[tp, _c(q, qpos + 1)]
            if (tpos == len(t) - 1 or t[tpos + 1] == 0) and tp > 2:
                x += T.term_au
    return float(x) / 100.0


def search_pair(qseq: str, tseq: str, qacc, qcond, tacc, tcond, p: dict):
    """The hits of one query against one target, in the reference's
    order. Each is a dict: the query's and the target's first and last
    base pair (target positions forward, 0-based); for the pair's first
    hit also `first_last_raw`, the same of its pairs in the order they
    were found (the form the reference prints for a query's first hit of
    a page, whose pairs it leaves unsorted; None for the others); and
    the three energies."""
    tables()
    rd = p.get("round", exact)
    q, t = encode_query(qseq), encode_target(tseq)
    lt = len(tseq)
    d = p["min_acc_len"]
    qacc, qcond = np.asarray(qacc, np.float32), np.asarray(qcond, np.float32)
    tacc, tcond = np.asarray(tacc, np.float32), np.asarray(tcond, np.float32)
    ii, jj, ll, sc = seeds(q, t, p)
    hits = []
    for i, j, L, e in zip(ii.tolist(), jj.tolist(), ll.tolist(), sc.tolist()):
        start = lt - j - L
        qa = _window_access(qacc, qcond, i, L, d, rd)
        ta = _window_access(tacc, tcond, start, L, d, rd)
        if rd(rd(qa + ta) + e) < 0:
            hits.append(Hit(i, j, L, start, rd(qa + ta), e))
    for h in hits:
        ungapped(h, q, t, qacc, qcond, tacc, tcond, p)
    hits.sort(key=Hit.key)
    hits = drop_redundant(hits, p["interaction_thr"])
    for h in hits:
        h.bps = [(h.q_sp + k, h.db_sp + k) for k in range(h.q_len)
                 if _pair(q, t, h.q_sp + k, h.db_sp + k) != 0]
    for h in hits:
        gapped(h, q, t, qacc, qcond, tacc, tcond, p, 0)
        gapped(h, q, t, qacc, qcond, tacc, tcond, p, 1)
    for h in hits:
        d5 = _dangle(q, t, h.q_sp, h.db_sp, 0)
        d3 = _dangle(q, t, h.q_sp + h.q_len - 1, h.db_sp + h.db_len - 1, 1)
        h.energy = rd(rd(h.energy + d5) + d3)
        h.hyb_e = rd(rd(h.hyb_e + d5) + d3)
    # the reference sorts the pairs of every hit but the first
    # (rna_interaction_search.cpp:314-317)
    raw = {id(hits[0]): (hits[0].bps[0], hits[0].bps[-1])} if hits else {}
    for h in hits:
        h.bps.sort(key=lambda bp: bp[0])
    hits.sort(key=Hit.key)
    hits = drop_redundant(hits, p["final_thr"])
    out = []
    for h in hits:
        (q1, t1), (q2, t2) = h.bps[0], h.bps[-1]
        first_raw = None
        if id(h) in raw:
            (rq1, rt1), (rq2, rt2) = raw[id(h)]
            first_raw = (rq1, rq2, lt - 1 - rt1, lt - 1 - rt2)
        out.append({
            "first_last": (q1, q2, lt - 1 - t1, lt - 1 - t2),
            "first_last_raw": first_raw,
            "acc": h.acc_e, "hyb": h.hyb_e, "energy": h.energy})
    return out
