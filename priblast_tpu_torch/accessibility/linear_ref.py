"""Linear-domain scaled parameter tables for the accessibility DP.

The reference computes the McCaskill-style inside/outside DP in log space
with pairwise log-sum-exp (src/raccess.cpp:99-412). The batched engine
(accessibility/batched.py) runs the same DP in the *linear*
(Boltzmann-weight) domain with ViennaRNA-style scaling:

- banded state cell (i, j) is stored at ``[column j][span d = j - i]`` as
  ``value / sigma^d`` (per-spanned-base scale sigma keeps magnitudes near 1);
- the exterior arrays are kept in log space (``A[j] = log alpha_outer[j]``,
  ``B[i] = log beta_outer[i]``) since they span the whole sequence;
- outside (beta) band states are normalized by the partition function;
- the O(N*W*MAXLOOP^2) interior-loop sums become small dense convolutions
  with a fixed kernel ``K[u1][u2] = exp(internal(u1+u2) + ninio(|u1-u2|)) *
  sigma^-(u1+u2)`` (plus separable mismatch pre/post factors and a handful
  of non-separable small-loop corrections).

This module holds the numpy tables of that formulation.
"""

from __future__ import annotations

import numpy as np

from priblast_tpu_torch.utils import thermo

TURN = thermo.TURN
ML = thermo.MAXLOOP


class LinearModel:
    """Precomputed linear-domain parameter tables. All weights are
    exp(scaled energy) with the -10/kT scaling of utils.thermo.scaled()."""

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
