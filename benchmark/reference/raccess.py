"""Linear-domain scaled formulation of the accessibility DP — numpy oracle
for the TPU engine.

The reference computes the McCaskill-style inside/outside DP in log space
with pairwise log-sum-exp (src/raccess.cpp:99-412). That formulation is
transcendental-bound and hostile to matrix units. This module re-derives the
same DP in the *linear* (Boltzmann-weight) domain with ViennaRNA-style
scaling, which is the formulation the batched TPU engine uses:

- banded state cell (i, j) is stored at ``[column j][span d = j - i]`` as
  ``value / sigma^d`` (per-spanned-base scale sigma keeps magnitudes near 1);
- the exterior arrays are kept in log space (``A[j] = log alpha_outer[j]``,
  ``B[i] = log beta_outer[i]``) since they span the whole sequence;
- outside (beta) band states are normalized by the partition function:
  ``bbar_X[q][d] = beta_X * sigma^d / Z`` — all cross-references then only
  involve *local* exponent differences, which are bounded by the band;
- the O(N*W*MAXLOOP^2) interior-loop sums become small dense convolutions
  with a fixed kernel ``K[u1][u2] = exp(internal(u1+u2) + ninio(|u1-u2|)) *
  sigma^-(u1+u2)`` (plus separable mismatch pre/post factors and a handful
  of non-separable small-loop corrections), which is what the TPU engine
  maps onto the MXU.

Semantics match the reference recurrences exactly up to floating-point
associativity; validated against the exact engine to ~1e-9 relative in f64.
"""

from __future__ import annotations

import numpy as np

from . import thermo

TURN = thermo.TURN
ML = thermo.MAXLOOP



def _interior_pairs():
    """The (u1, u2) of the general interior loops: both sides >= 1,
    u1 + u2 <= ML, the four small loops left to their own tables."""
    u1, u2 = np.meshgrid(np.arange(ML + 1), np.arange(ML + 1), indexing="ij")
    keep = (u1 >= 1) & (u2 >= 1) & (u1 + u2 <= ML)
    for a, b in ((1, 1), (1, 2), (2, 1), (2, 2)):
        keep[a, b] = False
    return u1[keep], u2[keep]


_U1, _U2 = _interior_pairs()


def _conv(arr: np.ndarray, rows: np.ndarray, src: np.ndarray,
          ok: np.ndarray, k: np.ndarray) -> np.ndarray:
    """The interior-loop contraction of one column: for each span d, the
    sum over the loops (u1, u2) of arr[rows[u], src[d, u]] * k[u] where
    ok[d, u] (the loop nested in the span's own pair)."""
    vals = arr[rows[None, :], np.clip(src, 0, arr.shape[1] - 1)]
    return np.where(ok, vals, 0.0) @ k


_UB = np.arange(2, ML + 1)  # bulge sizes past 1


def _ext_sum(sv, sig, dw, dlog):
    """One exterior-scan step: the sum over the stems ending here of
    stem * sigma^span * dangle * e^(exterior difference), stems of
    weight 0 left out."""
    live = sv != 0.0
    return float((sv[live] * sig[live] * dw[live] * np.exp(dlog[live])).sum())


def _ragged_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenation of arange(starts[i], starts[i] + counts[i])."""
    total = int(counts.sum())
    first = np.repeat(np.cumsum(counts) - counts, counts)
    return np.repeat(starts, counts) + np.arange(total) - first


class LinearModel:
    """Precomputed linear-domain parameter tables (shared by numpy and JAX
    engines). All weights are exp(scaled energy) with the -10/kT scaling of
    priblast_tpu.utils.thermo.scaled()."""

    def __init__(self, w_span: int, log_sigma: float = 1.0):
        sp = thermo.scaled()
        self.sp = sp
        self.w = w_span
        self.lsig = log_sigma
        r = thermo.RAW

        self.bp = r.BP_pair.astype(np.int32)          # (5,5)
        self.rtype = r.rtype.astype(np.int32)         # (7,)

        e = np.exp
        self.W_stack = e(sp.stack)                    # (7,7): [type][type2r]
        self.W_int11 = e(sp.int11)
        self.W_int21 = e(sp.int21)
        self.W_int22 = e(sp.int22)
        self.W_mism_i = e(sp.mismatch_i)              # (7,5,5)
        self.W_mism_h = e(sp.mismatch_h)
        self.W_dangle5 = e(sp.dangle5)                # (8,5)
        self.W_dangle3 = e(sp.dangle3)
        self.W_au = np.ones(7)
        self.W_au[3:] = e(sp.term_au)                 # types 3..6 get TermAU
        self.W_mlb = e(sp.ml_base)
        self.W_mli = e(sp.ml_intern)
        self.W_mlc = e(sp.ml_closing)

        # hairpin length table extended past 30 with the log extrapolation
        # (reference: src/raccess.cpp:819-823); bulge likewise (:784).
        max_d = w_span + 2
        hp = np.empty(max_d + 1)
        bu = np.empty(max_d + 1)
        for dd in range(max_d + 1):
            if dd <= 30:
                hp[dd] = sp.hairpin[dd]
                bu[dd] = sp.bulge[dd]
            else:
                ext = sp.lxc * np.log(dd / 30.0) * 10.0 / sp.kT
                hp[dd] = sp.hairpin[30] - ext
                bu[dd] = sp.bulge[30] - ext
        self.W_hairpin_len = e(hp)
        self.W_bulge_len = e(bu)

        # dense interior kernel K[u1][u2], u1,u2 in 0..ML:
        # general-internal entries only (u1,u2 >= 1, u1+u2 <= ML), with the
        # non-separable small loops (1,1),(1,2),(2,1),(2,2) zeroed — they are
        # added as explicit shifted terms.
        K = np.zeros((ML + 1, ML + 1))
        for u1 in range(1, ML + 1):
            for u2 in range(1, ML + 1):
                if u1 + u2 > ML:
                    continue
                if (u1, u2) in ((1, 1), (1, 2), (2, 1), (2, 2)):
                    continue
                K[u1, u2] = np.exp(sp.internal[u1 + u2] +
                                   sp.ninio[abs(u1 - u2)] -
                                   (u1 + u2) * log_sigma)
        self.K_int = K
        # bulge kernel (u >= 2; u == 1 needs the stack term, handled apart)
        kb = np.zeros(ML + 1)
        for u in range(2, ML + 1):
            kb[u] = np.exp(bu[u] - u * log_sigma)
        self.K_bulge = kb

        self.sig_pow = np.exp(log_sigma * np.arange(max_d + 2))
        self.inv_sig_pow = np.exp(-log_sigma * np.arange(max_d + 2))


def _pad_seq(codes: np.ndarray) -> np.ndarray:
    """1-based int sequence with s[0] = 0 and generous zero padding at the
    end, so boundary reads like s[q+3] resolve to 'unknown' (their
    contributions are masked out anyway)."""
    n = len(codes)
    s = np.zeros(n + ML + 4, dtype=np.int32)
    s[1 : n + 1] = codes
    return s


class LinearRaccess:
    """Unbatched numpy f64 implementation; mirrors the structure of the
    batched JAX engine column for column."""

    def __init__(self, w_span: int, min_acc_len: int, log_sigma: float = 1.0):
        self.m = LinearModel(w_span, log_sigma)
        self.w = w_span
        self.d = min_acc_len

    # -- inside pass --------------------------------------------------------

    def inside(self, s: np.ndarray, n: int):
        m, W = self.m, self.w
        B = W + 2  # band size (spans 0..W+1)
        shape = (n + 1, B)
        stem = np.zeros(shape)
        stemend = np.zeros(shape)
        multi = np.zeros(shape)
        multibif = np.zeros(shape)
        multi1 = np.zeros(shape)
        multi2 = np.zeros(shape)
        # prefolded copies for the stemend interior conv
        stem_mism = np.zeros(shape)   # stem * exp(mismatchI[rtype(t)][s+1][s-])
        stem_au = np.zeros(shape)     # stem * AU(rtype(t))
        A = np.zeros(n + 1)           # log alpha_outer

        ds = np.arange(B)
        lsig = m.lsig

        for j in range(TURN + 1, n + 1):
            dlo, dhi = TURN, min(W + 1, j)  # spans computed this column
            dv = ds[dlo : dhi + 1]
            iv = j - dv

            t1 = m.bp[s[iv + 1], s[j]]
            t2r = m.rtype[m.bp[s[iv + 2], s[j - 1]]]

            # stem (reference: raccess.cpp:102-129)
            stackw = m.W_stack[t1, t2r]
            inner = stem[j - 1, dv - 2] * stackw + stemend[j - 1, dv - 2]
            stem_col = np.where(t1 != 0, inner * np.exp(-2 * lsig), 0.0)
            stem[j, dlo : dhi + 1] = stem_col

            # prefolds for later stemend/biloop convs: this cell as the inner
            # helix (p,q) of an interior loop. q+1 = j+1, p = i.
            t_cell_r = m.rtype[t1]
            stem_mism[j, dlo : dhi + 1] = stem_col * m.W_mism_i[t_cell_r, s[j + 1], s[iv]]
            stem_au[j, dlo : dhi + 1] = stem_col * m.W_au[t_cell_r]

            # multi2 (reference: raccess.cpp:145-162)
            dangle = self._dangle_w(s, n, t1, iv, j)
            multi2[j, dlo : dhi + 1] = (
                np.where(t1 != 0, stem_col * m.W_mli * dangle, 0.0)
                + multi2[j - 1, dv - 1] * m.W_mlb * np.exp(-lsig))

            # multibif (reference: raccess.cpp:131-143):
            # mb[d] = sum_u multi1[j-u][d-u] * multi2[j][u]
            us = np.arange(1, dhi)
            mb = np.zeros(B)
            mb[dlo : dhi + 1] = _conv(multi1, j - us, dv[:, None] - us,
                                      dv[:, None] >= us + 1, multi2[j, us])
            multibif[j, dlo : dhi + 1] = mb[dlo : dhi + 1]

            # multi1, multi (reference: raccess.cpp:164-191)
            multi1[j, dlo : dhi + 1] = multi2[j, dlo : dhi + 1] + mb[dlo : dhi + 1]
            decay = m.W_mlb * np.exp(-lsig)
            prev, mbv, col = float(multi[j, dlo - 1]), mb.tolist(), []
            for dd in range(dlo, dhi + 1):
                prev = prev * decay + mbv[dd]
                col.append(prev)
            multi[j, dlo : dhi + 1] = col

            # stemend (reference: raccess.cpp:193-226) — only for j != n
            if j != n:
                stemend[j, dlo : dhi + 1] = self._stemend_col(
                    s, n, j, dv, iv, stem, stem_mism, stem_au, multi)

            # exterior log-scan (reference: raccess.cpp:231-241)
            # A[j] = A[j-1] + log(1 + sum_p stem[j][j-p] sig^(j-p) dW e^(A[p]-A[j-1]))
            dps = np.arange(1, min(W + 1, j) + 1)
            p = j - dps
            tt = m.bp[s[p + 1], s[j]]
            acc = _ext_sum(stem[j, dps], m.sig_pow[dps],
                           self._dangle_w(s, n, tt, p, j), A[p] - A[j - 1])
            A[j] = A[j - 1] + np.log1p(acc)

        # columns j <= TURN: A[j] stays A[j-1] (= 0) — matches reference
        # (alpha_outer starts at 0 and no stems exist below TURN+1).
        return stem, stemend, multi, multibif, multi1, multi2, stem_mism, stem_au, A

    def _dangle_w(self, s, n, types, a_pos, b_pos):
        """Vectorized exp(CalcDangleEnergy(type, a, b))
        (reference: raccess.cpp:244-256). a_pos vector, b_pos scalar or vec."""
        m = self.m
        types = np.asarray(types)
        a_pos = np.asarray(a_pos)
        b_vec = np.broadcast_to(np.asarray(b_pos), types.shape)
        w = np.ones(types.shape)
        w = np.where(a_pos > 0, m.W_dangle5[types, s[a_pos]], w)
        w3 = np.where(b_vec < n, m.W_dangle3[types, s[np.minimum(b_vec + 1, n + 2)]], 1.0)
        wau = np.where((b_vec == n) & (types > 2), m.W_au[np.minimum(types, 6)], 1.0)
        return np.where(types != 0, w * w3 * wau, 1.0)

    def _dangle_w_scalar(self, s, n, t, a, b):
        if t == 0:
            return 1.0
        m = self.m
        w = 1.0
        if a > 0:
            w *= m.W_dangle5[t, s[a]]
        if b < n:
            w *= m.W_dangle3[t, s[b + 1]]
        if b == n and t > 2:
            w *= m.W_au[t]
        return w

    def _hairpin_w(self, s, types, i_vec, j):
        """Vectorized exp(HairpinEnergy(type, i, j)) (reference:
        raccess.cpp:819-832); loop size dd = j - i - 1."""
        m = self.m
        dd = j - i_vec - 1
        q = m.W_hairpin_len[dd]
        mism = m.W_mism_h[types, s[i_vec + 1], s[j - 1]]
        au = m.W_au[np.minimum(types, 6)]
        return np.where(dd != 3, q * mism, q * np.where(types > 2, au, 1.0))

    def _stemend_col(self, s, n, j, dv, iv, stem, stem_mism, stem_au, multi):
        """One stemend column: hairpin + interior-loop conv + specials +
        multiloop closing. Closing pair is (i, j+1)."""
        m = self.m
        B = self.w + 2
        tC = m.bp[s[iv], s[j + 1]]
        valid = tC != 0

        # hairpin term, scaled by sigma^-d
        out = self._hairpin_w(s, tC, iv, j + 1) * m.inv_sig_pow[dv]

        # --- general interior conv: sum over u1,u2>=1 of
        #     stem_mism[j-u2][d-u1-u2] * K[u1][u2], postfactor mismatchI.
        sel = _U2 <= j
        u1s, u2s = _U1[sel], _U2[sel]
        src = dv[:, None] - (u1s + u2s)[None, :]
        ok = src >= TURN + 2  # q - p >= TURN + 2 in reference bounds
        gen = _conv(stem_mism, j - u2s, src, ok, m.K_int[u1s, u2s])
        out = out + gen * m.W_mism_i[tC, s[iv + 1], s[j]]

        # --- bulge arms (u >= 2): postfactor AU(closing type)
        us = _UB[_UB <= j]
        src = dv[:, None] - us[None, :]
        ok = src >= TURN + 2
        # u1 = u, u2 = 0 (bulge on 5' arm): stem at [j][d-u]; u1 = 0,
        # u2 = u (bulge on 3' arm): stem at [j-u][d-u]
        blg = (_conv(stem_au, np.full(len(_UB), j), dv[:, None] - _UB,
                     dv[:, None] - _UB >= TURN + 2, m.K_bulge[_UB])
               + _conv(stem_au, j - us, src, ok, m.K_bulge[us]))
        out = out + blg * m.W_au[np.minimum(tC, 6)]

        # --- non-separable small loops. Each reads the stem cell at
        # (p, q) = (i+u1, j-u2) = [col j-u2][span d-u1-u2] and weights by the
        # exact table entry; t2r = rtype[type of that stem cell].
        def cell_t2r(u1, u2):
            return m.rtype[m.bp[s[iv + u1 + 1], s[j - u2]]]

        def cell_stem(u1, u2):
            src = dv - u1 - u2
            v = stem[j - u2, np.maximum(src, 0)]
            return np.where(src >= TURN + 2, v, 0.0)

        sig = lambda k: np.exp(-k * m.lsig)
        b1 = m.W_bulge_len[1]
        # (u1,u2) = (1,0) and (0,1): 1-bulges keep the stack term
        out = out + cell_stem(1, 0) * b1 * m.W_stack[tC, cell_t2r(1, 0)] * sig(1)
        out = out + cell_stem(0, 1) * b1 * m.W_stack[tC, cell_t2r(0, 1)] * sig(1)
        # (1,1): int11[tC][t2r][s[i+1]][s[j]]
        out = out + cell_stem(1, 1) * m.W_int11[tC, cell_t2r(1, 1), s[iv + 1], s[j]] * sig(2)
        # (1,2): int21[tC][t2r][s[i+1]][s[q+1]=s[j-1]][s[j]]
        out = out + cell_stem(1, 2) * m.W_int21[tC, cell_t2r(1, 2), s[iv + 1], s[j - 1], s[j]] * sig(3)
        # (2,1): int21[t2r][tC][s[q+1]=s[j]][s[i+1]][s[p]=s[i+2]]
        out = out + cell_stem(2, 1) * m.W_int21[cell_t2r(2, 1), tC, s[j], s[iv + 1], s[iv + 2]] * sig(3)
        # (2,2): int22[tC][t2r][s[i+1]][s[p]=s[i+2]][s[q+1]=s[j-1]][s[j]]
        out = out + cell_stem(2, 2) * m.W_int22[tC, cell_t2r(2, 2), s[iv + 1], s[iv + 2], s[j - 1], s[j]] * sig(4)

        # --- multiloop closing (reference: raccess.cpp:217-221)
        ttr = m.rtype[tC]
        out = out + multi[j, dv] * m.W_mlc * m.W_mli * \
            m.W_dangle3[ttr, s[iv + 1]] * m.W_dangle5[ttr, s[j]]

        return np.where(valid, out, 0.0)

    # -- outside pass -------------------------------------------------------

    def outside(self, s, n, stem, multi1, multi2, A):
        """Outside (beta) pass (reference: raccess.cpp:258-412). Banded
        arrays are bbar_X[q][d] = beta_X * sigma^d / Z; B = log beta_outer."""
        m, W = self.m, self.w
        Bsz = W + 2
        shape = (n + 2, Bsz)  # +1 col of zeros so [q+1] reads are safe
        b_stem = np.zeros(shape)
        b_stemend = np.zeros(shape)
        b_multi = np.zeros(shape)
        b_multibif = np.zeros(shape)
        b_multi1 = np.zeros(shape)
        b_multi2 = np.zeros(shape)
        # prefolded for the beta-side interior conv (stemend cell (i,j) as
        # the OUTER closing of the loop): mismatchI[type(i,j+1)][s[i+1]][s[j]]
        bse_mism = np.zeros(shape)
        bse_au = np.zeros(shape)
        Bl = np.zeros(n + 1)  # log beta_outer
        lsig = m.lsig
        logZ = A[n]

        # log beta_outer backward scan (reference: raccess.cpp:260-271)
        for i in range(n - 1, -1, -1):
            dps = np.arange(1, min(W + 1, n - i) + 1)
            p = i + dps
            tt = m.bp[s[i + 1], s[p]]
            acc = _ext_sum(stem[p, dps], m.sig_pow[dps],
                           self._dangle_w(s, n, tt, np.full(len(p), i), p),
                           Bl[p] - Bl[i + 1])
            Bl[i] = Bl[i + 1] + np.log1p(acc)

        ds = np.arange(Bsz)
        for q in range(n, TURN, -1):
            dlo, dhi = TURN, min(W + 1, q)
            dv = ds[dlo : dhi + 1]
            pv = q - dv
            interior = (pv != 0) & (q != n)

            # stemend (reference: raccess.cpp:277-279)
            se = np.where(dv >= W, 0.0,
                          b_stem[q + 1, np.minimum(dv + 2, Bsz - 1)] *
                          np.exp(-2 * lsig))
            se = np.where(interior, se, 0.0)
            b_stemend[q, dlo : dhi + 1] = se

            # prefolds: this stemend cell closes pair (p, q+1). Contributions
            # require that closing type != 0 (reference: raccess.cpp:376-377),
            # which is NOT implied by the beta value — mask explicitly.
            tCv = m.bp[s[pv], s[q + 1]]
            cmask = tCv != 0
            bse_mism[q, dlo : dhi + 1] = np.where(
                cmask, se * m.W_mism_i[tCv, s[pv + 1], s[q]], 0.0)
            bse_au[q, dlo : dhi + 1] = np.where(
                cmask, se * m.W_au[np.minimum(tCv, 6)], 0.0)

            # multi (reference: raccess.cpp:281-308): d-descending scan
            ttv = m.rtype[tCv]
            clos = se * m.W_mlc * m.W_mli * \
                m.W_dangle3[ttv, s[pv + 1]] * m.W_dangle5[ttv, s[q]]
            decay = m.W_mlb * np.exp(-lsig)
            up, cl, inner = 0.0, clos.tolist(), interior.tolist()
            col = [0.0] * len(dv)
            for k in range(len(dv) - 1, -1, -1):
                up = up * decay + cl[k] if inner[k] else 0.0
                col[k] = up
            b_multi[q, dlo : dhi + 1] = col

            # multi1 (reference: raccess.cpp:310-324):
            # bm1[d] = sum_t bmb[q+t][t+d] * multi2[q+t][t]
            ts = np.arange(1, min(W, n - q) + 1)
            # reference bound k <= p + W (raccess.cpp:313)
            bm1 = _conv(b_multibif, q + ts, dv[:, None] + ts,
                        dv[:, None] + ts <= W, multi2[q + ts, ts])
            bm1 = np.where(interior, bm1, 0.0)
            b_multi1[q, dlo : dhi + 1] = bm1

            # multibif = multi1 + multi (reference: raccess.cpp:354-364)
            bmb = bm1 + b_multi[q, dlo : dhi + 1]
            b_multibif[q, dlo : dhi + 1] = np.where(interior, bmb, 0.0)

            # multi2 (reference: raccess.cpp:326-352): needs same-column
            # multibif at larger spans plus earlier columns of multi1.
            # sum_{e>d} bmb[q][e] * multi1[q-d][e-d]; reference bound
            # k >= q - W limits e = q - k to W (raccess.cpp:342)
            fs = np.arange(1, Bsz)
            e = dv[:, None] + fs
            same = np.where(e <= min(dhi, W),
                            b_multibif[q, np.minimum(e, Bsz - 1)]
                            * multi1[(q - dv)[:, None], fs], 0.0).sum(axis=1)
            nxt = np.where(dv + 1 < Bsz,
                           b_multi2[q + 1, np.minimum(dv + 1, Bsz - 1)] * decay,
                           0.0)
            b_multi2[q, dlo : dhi + 1] = np.where(interior, bm1 + nxt + same,
                                                  0.0)

            # stem (reference: raccess.cpp:367-409)
            b_stem[q, dlo : dhi + 1] = self._b_stem_col(
                s, n, q, dv, pv, b_stemend, bse_mism, bse_au, b_stem,
                b_multi2, A, Bl, logZ)

        return b_stem, b_stemend, b_multi, b_multibif, b_multi1, b_multi2, Bl

    def _b_stem_col(self, s, n, q, dv, pv, b_stemend, bse_mism, bse_au,
                    b_stem, b_multi2, A, Bl, logZ):
        m = self.m
        Bsz = self.w + 2
        t2 = m.bp[s[pv + 1], s[q]]
        valid = t2 != 0
        t2r = m.rtype[t2]

        # exterior seed: exp(A[p] + B[q] - logZ + d*lsig) * dangle
        dw = self._dangle_w(s, n, t2, pv, q)
        out = np.exp(A[pv] + Bl[q] - logZ + dv * m.lsig) * dw

        # interior conv over future stemend cells: (v1, v2) = (p-i, j-q),
        # reading bse[q+v2][d+v1+v2]; kernel mirrors the inside conv.
        sel = _U2 <= n - q
        v1s, v2s = _U1[sel], _U2[sel]
        src = dv[:, None] + (v1s + v2s)[None, :]
        ok = src <= self.w + 1
        gen = _conv(bse_mism, q + v2s, src, ok, m.K_int[v1s, v2s])
        out = out + gen * m.W_mism_i[t2r, s[q + 1], s[pv]]

        us = _UB[_UB <= n - q]
        blg = (_conv(bse_au, np.full(len(_UB), q), dv[:, None] + _UB,
                     dv[:, None] + _UB <= self.w + 1, m.K_bulge[_UB])
               + _conv(bse_au, q + us, dv[:, None] + us,
                       dv[:, None] + us <= self.w + 1, m.K_bulge[us]))
        out = out + blg * m.W_au[np.minimum(t2r, 6)]

        # non-separable small loops, mirrored: outer closing type is the
        # stemend cell's own (prefold impossible for stack/int tables), so
        # gather per (v1, v2) with the closing type read from the sequence.
        def closing_type(v1, v2):
            # stemend cell (i, j) with i = p - v1, j = q + v2 closes (i, j+1)
            return m.bp[s[pv - v1], s[q + v2 + 1]]

        def bse_cell(v1, v2):
            src = dv + v1 + v2
            col = q + v2
            if col > n:
                return np.zeros(len(dv))
            v = b_stemend[col, np.minimum(src, Bsz - 1)]
            return np.where(src <= self.w + 1, v, 0.0)

        sig = lambda k: np.exp(-k * m.lsig)
        b1 = m.W_bulge_len[1]
        tc10 = closing_type(1, 0)
        out = out + bse_cell(1, 0) * b1 * m.W_stack[tc10, t2r] * sig(1)
        tc01 = closing_type(0, 1)
        out = out + bse_cell(0, 1) * b1 * m.W_stack[tc01, t2r] * sig(1)
        # int tables have weight-1 entries at type 0, so mask closing != 0
        tc11 = closing_type(1, 1)
        out = out + np.where(tc11 != 0, bse_cell(1, 1) *
                             m.W_int11[tc11, t2r, s[pv], s[q + 1]], 0.0) * sig(2)
        tc12 = closing_type(1, 2)
        out = out + np.where(tc12 != 0, bse_cell(1, 2) *
                             m.W_int21[tc12, t2r, s[pv], s[q + 1], s[q + 2]],
                             0.0) * sig(3)
        tc21 = closing_type(2, 1)
        out = out + np.where(tc21 != 0, bse_cell(2, 1) *
                             m.W_int21[t2r, tc21, s[q + 1], s[pv - 1], s[pv]],
                             0.0) * sig(3)
        tc22 = closing_type(2, 2)
        out = out + np.where(tc22 != 0, bse_cell(2, 2) *
                             m.W_int22[tc22, t2r, s[pv - 1], s[pv], s[q + 1],
                                       s[q + 2]], 0.0) * sig(4)

        # helix continuation outward (reference: raccess.cpp:388-398)
        tcont = m.bp[s[pv], s[q + 1]]
        cont = np.where((pv != 0) & (q != n),
                        b_stem[q + 1, np.minimum(dv + 2, Bsz - 1)] *
                        np.where(dv + 2 <= self.w + 1, 1.0, 0.0) *
                        m.W_stack[tcont, t2r] * sig(2),
                        0.0)
        out = out + np.where(tcont != 0, cont, 0.0)

        # multiloop participation (reference: raccess.cpp:401-406)
        out = out + b_multi2[q, dv] * m.W_mli * dw

        return np.where(valid, out, 0.0)

    # -- probability passes -------------------------------------------------

    def _window_probs(self, s, n, w, stem, stem_mism, stem_au, multi, multi2,
                      b_stemend, b_multi, b_multi2, A, Bl):
        """P(window of size w starting at x unpaired), split into the four
        structural contexts, for x = 1..n-w+1 — plus the 'conditional'
        variants (window size w+1) needed by the incremental energies.
        Returns (p_win[w], hairpin_b, hairpin_c, biloop_b, biloop_c,
        multi fn) pieces combined as in reference raccess.cpp:421-528."""
        m, W = self.m, self.w
        Bsz = W + 2
        logZ = A[n]
        sigw = np.exp(-w * m.lsig)

        # exterior (reference: raccess.cpp:530-534), windows w and w+1
        xs = np.arange(1, n + 2)
        ext_w = np.zeros(n + 2)
        k = n - w + 1
        if k >= 1:
            ext_w[1 : k + 1] = np.exp(A[xs[:k] - 1] + Bl[xs[:k] + w - 1] - logZ)
        ext_w1 = np.zeros(n + 2)
        k1 = n - w
        if k1 >= 1:
            ext_w1[1 : k1 + 1] = np.exp(A[xs[:k1] - 1] + Bl[xs[:k1] + w] - logZ)

        # hairpin (reference: raccess.cpp:536-579): cell (i, j) contributes
        # hp(i,j) to every window x in [i+1, j-w]; boundary x = j-w goes to
        # the unconditional array, the rest to the conditional one.
        hp_b = np.zeros(n + 2)
        hp_c = np.zeros(n + 2)
        # HP[j][e]: pair (i, j), e = j - i, value bse[j-1][e-1]*hpW*sig^-(e-1)
        for e in range(w + 1, W + 1):
            js = np.arange(e + 1, n + 1)  # j ranges; i = j - e >= 1
            iv = js - e
            t = m.bp[s[iv], s[js]]
            hp = b_stemend[js - 1, e - 1] * self._hairpin_w(s, t, iv, js) * \
                m.inv_sig_pow[e - 1]
            # boundary window x = j - w
            np.add.at(hp_b, js - w, hp)
            # conditional windows x in [i+1, j-w-1] via difference array
            dif = np.zeros(n + 3)
            np.add.at(dif, iv + 1, hp)
            np.add.at(dif, js - w, -hp)
            hp_c[: n + 2] += np.cumsum(dif)[: n + 2]
        hairpin_b = hp_b + hp_c  # total over [i+1, j-w] (reference lse-joins)
        hairpin_c = hp_c

        # multiloop (reference: raccess.cpp:581-612), window sizes w and w+1
        # vectorized multi parts (see derivation in module docstring):
        def multi_prob_vec(wsz):
            sigf = np.exp(-wsz * m.lsig)
            out = np.zeros(n + 2)
            # part 1: sum_t bbar_multi[(x-1)+t][t] * multi_s[x+wsz-1..][t-wsz]
            #   where t = i - (x-1), i = the right end; t in [wsz, W+1]
            for t in range(wsz, W + 2):
                imax = n  # i = x-1+t <= n
                xs_ = np.arange(1, min(n - wsz + 1, imax - t + 1) + 1)
                if len(xs_) == 0:
                    continue
                i_ = xs_ - 1 + t
                t2 = t - wsz  # span of alpha multi cell (x+wsz-1, i)
                vals = b_multi[i_, t] * multi[i_, t2]
                out[xs_] += vals
            # part 2: sum_t bbar_multi2[x+wsz-1][t+wsz] * multi2_s[x-1][t]
            #   t = x-1-k in [0, W-wsz]
            for t in range(0, W - wsz + 1):
                xs_ = np.arange(max(1, 1), n - wsz + 2)
                x_ = xs_
                c1 = x_ + wsz - 1  # column of bbar_multi2
                ok = (c1 <= n) & (x_ - 1 - t >= 0) & (t + wsz <= W + 1)
                c1c = np.minimum(c1, n)
                vals = np.where(ok, b_multi2[c1c, t + wsz] *
                                multi2[np.maximum(x_ - 1, 0), t], 0.0)
                out[x_] += vals
            out *= sigf
            return out

        mp_w = multi_prob_vec(w)
        mp_w1 = multi_prob_vec(w + 1)

        # bulge/internal ("biloop", reference: raccess.cpp:614-681): loop
        # (i, j, p, q): contribution spreads left over k in [i+1, p-w] and
        # right over k in [q+1, j-w]; boundary k = p-w / j-w unconditional.
        bi_b = np.zeros(n + 2)
        bi_c = np.zeros(n + 3)
        dif_c = np.zeros(n + 4)
        logZ = A[n]
        zb_half = np.exp(min(logZ, 700.0) / 2)
        zboost = zb_half * zb_half
        for u1 in range(0, ML + 1):
            for u2 in range(0, ML + 1):
                if u1 + u2 > ML or (u1 == 0 and u2 == 0):
                    continue
                # pairs (i, j), e = j - i; p = i + u1 + 1, q = j - u2 - 1
                # stem cell (p-1, q) = [q][q-p+1] = [j-u2-1][e-u1-u2-2+1]
                # every span e at once: the (i, j) diagonals of all e
                # flattened into one vector
                es = np.arange(u1 + u2 + TURN + 3, W + 1)
                espans = es - u1 - u2 - 1  # span of stem cell (p-1, q)
                es = es[(espans >= TURN + 1) & (espans <= W + 1)]
                if len(es) == 0 or es[0] + 1 > n:
                    continue
                counts = np.maximum(n - es, 0)
                e = np.repeat(es, counts)
                js = _ragged_ranges(es + 1, counts)
                iv = js - e
                tcl = m.bp[s[iv], s[js]]
                q_ = js - u2 - 1
                espan = e - u1 - u2 - 1
                wgt = self._biloop_weight(s, tcl, iv, js, u1, u2, q_, espan,
                                          stem, stem_mism, stem_au)
                contrib = b_stemend[js - 1, e - 1] * wgt
                # bi_b is accumulated at the reference's RAW scale
                # (boost by Z) so its nonzero test matches exactly;
                # unboosted when assembling the probability.
                contrib_raw = (b_stemend[js - 1, e - 1] * zb_half) * \
                    (wgt * zb_half)
                # the reference's expd clamps each term below e^-708.39
                # to exactly zero (fmath.hpp:438-440) — replicate the
                # per-term cliff so the boundary nonzero-gate matches
                contrib_raw = np.where(
                    contrib_raw >= 2.43e-308, contrib_raw, 0.0)
                # left spread: k in [i+1, p-w] = [i+1, i+u1+1-w]
                if u1 + 1 - w >= 1:
                    np.add.at(bi_b, iv + u1 + 1 - w, contrib_raw)
                    if u1 + 1 - w >= 2:
                        np.add.at(dif_c, iv + 1, contrib)
                        np.add.at(dif_c, iv + u1 + 1 - w, -contrib)
                # right spread: k in [q+1, j-w] = [j-u2, j-w]
                if u2 + 1 - w >= 1:
                    np.add.at(bi_b, js - w, contrib_raw)
                    if u2 + 1 - w >= 2:
                        np.add.at(dif_c, js - u2, contrib)
                        np.add.at(dif_c, js - w, -contrib)
        bi_c[: n + 2] = np.cumsum(dif_c)[: n + 2]
        # The reference's linear-space accumulation only folds the
        # conditional part into the total when the boundary sum is nonzero
        # (raccess.cpp:667-672). Its sums are raw (unnormalized) expd values,
        # whose smallest nonzero magnitude is ~e^-708.4; in our Z-normalized
        # space that zero test translates to a threshold e^(-708.4 - logZ).
        # bi_b holds raw-scale sums; the smallest nonzero expd in the
        # reference is ~e^-708.39, so test against that and unboost.
        # The reference then casts the raw sums to float32 before taking the
        # log (raccess.cpp:669-676); raw sums above f32-max saturate to inf
        # and fmath::log(inf) = 128*ln2f ~ 88.72, so the probability is
        # clamped at e^(88.72 - logZ). Replicated for both arrays. (For
        # |logZ| > 690 the reference takes its log-space branch, which joins
        # unconditionally and has no cast — no gate, no clamp.)
        if -690 <= logZ <= 690:
            clamp = np.exp(np.float64(128.0 * np.float32(np.log(2.0))) - logZ)
            gate = bi_b > np.exp(-708.0)
            biloop_b = np.where(
                gate, np.minimum(bi_b / zboost + bi_c[: n + 2], clamp), 0.0)
            biloop_c = np.minimum(bi_c[: n + 2], clamp)
        else:
            biloop_b = bi_b / zboost + bi_c[: n + 2]
            biloop_c = bi_c[: n + 2]

        return (ext_w, ext_w1, hairpin_b, hairpin_c, biloop_b, biloop_c,
                mp_w, mp_w1)

    def _biloop_weight(self, s, tcl, iv, js, u1, u2, q_, espan, stem,
                       stem_mism, stem_au):
        """exp(LoopEnergy(tcl, rtype(stem type), i, j, p, q)) * stem cell *
        sigma^-(u1+u2), vectorized over the (i, j) diagonal."""
        m = self.m
        sig = np.exp(-(u1 + u2) * m.lsig)
        stem_cell = stem[q_, espan]
        pv = iv + u1 + 1
        if u1 >= 1 and u2 >= 1 and (u1, u2) not in ((1, 1), (1, 2), (2, 1), (2, 2)):
            w = np.exp(m.sp.internal[u1 + u2] + m.sp.ninio[abs(u1 - u2)])
            inner = stem_mism[q_, espan]  # stem * mismI[rtype(t)][s[q+1]][s[p]]
            return np.where(tcl != 0,
                            inner * w * m.W_mism_i[tcl, s[iv + 1], s[js - 1]],
                            0.0) * sig
        if u1 == 0 or u2 == 0:
            u = u1 + u2
            if u == 1:
                t2r = m.rtype[m.bp[s[pv], s[q_]]]
                return np.where(tcl != 0,
                                stem_cell * m.W_bulge_len[1] *
                                m.W_stack[tcl, t2r], 0.0) * sig
            return np.where(tcl != 0,
                            stem_au[q_, espan] * m.W_bulge_len[u] *
                            m.W_au[np.minimum(tcl, 6)], 0.0) * sig
        t2r = m.rtype[m.bp[s[pv], s[q_]]]
        if (u1, u2) == (1, 1):
            w = m.W_int11[tcl, t2r, s[iv + 1], s[js - 1]]
        elif (u1, u2) == (1, 2):
            w = m.W_int21[tcl, t2r, s[iv + 1], s[q_ + 1], s[js - 1]]
        elif (u1, u2) == (2, 1):
            w = m.W_int21[t2r, tcl, s[q_ + 1], s[iv + 1], s[pv - 1]]
        else:  # (2, 2)
            w = m.W_int22[tcl, t2r, s[iv + 1], s[pv - 1], s[q_ + 1], s[js - 1]]
        return np.where(tcl != 0, stem_cell * w, 0.0) * sig

    # -- public API ---------------------------------------------------------

    def run(self, codes: np.ndarray):
        """Accessibility for one sequence of 0..4 codes. Returns float32
        (acc, cond) arrays with the same layout as the exact engine."""
        n = len(codes)
        w = self.d
        s = _pad_seq(codes)
        (stem, stemend, multi, multibif, multi1, multi2, stem_mism, stem_au,
         A) = self.inside(s, n)
        (b_stem, b_stemend, b_multi, b_multibif, b_multi1, b_multi2,
         Bl) = self.outside(s, n, stem, multi1, multi2, A)
        m = self.m
        (ext_w, ext_w1, hp_b, hp_c, bi_b, bi_c, mp_w, mp_w1) = \
            self._window_probs(s, n, w, stem, stem_mism, stem_au, multi,
                               multi2, b_stemend, b_multi, b_multi2, A, Bl)

        kT = m.sp.kT
        acc = np.zeros(n, dtype=np.float32)
        cond = np.zeros(n, dtype=np.float32)
        for x in range(1, n - w + 2):
            p = ext_w[x] + hp_b[x] + bi_b[x] + mp_w[x]
            acc[x - 1] = (-np.log(np.float32(p)) * kT) / 1000
        for x in range(1, n - w + 1):
            p = ext_w1[x] + hp_c[x] + bi_c[x] + mp_w1[x]
            cond[x + w - 1] = (-np.log(np.float32(p)) * kT) / 1000 - acc[x - 1]
        return acc, cond
