// Exact CPU engine for priblast_tpu_torch.
//
// This is the bit-exact correctness anchor of the framework: a fresh
// implementation of the accessibility partition function (McCaskill-style
// inside/outside DP restricted to base-pair span <= W) and of the
// seed-and-extend search chain, with arithmetic semantics matching the
// reference implementation operation-for-operation (reference files cited
// per function). The device (PyTorch/CUDA) path is validated against this engine,
// and parity test suites compare its end-to-end output byte-for-byte with the
// reference's predictions.txt.
//
// Exposed as extern "C" for ctypes. All buffers are caller-allocated numpy
// arrays; this library holds only the (immutable) parameter tables.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "fastmath.hpp"
#include "tables.hpp"

namespace rp {

// Parameter tables (set once from Python; values produced by
// priblast_tpu_torch.utils.thermo.scaled(), matching src/raccess.hpp:105-158).
Params g;

extern "C" void rp_set_params(
    const int *bp, const int *rtype, const double *hairpin,
    const double *mismatch_h, const double *mismatch_i, const double *stack,
    const double *bulge, const double *internal, const double *int11,
    const double *int21, const double *int22, const double *dangle5,
    const double *dangle3, const double *ninio, double ml_closing,
    double ml_intern, double ml_base, double term_au, double kT, double lxc,
    const int *stack37, const int *mismatchI37, const int *int11_37,
    const int *int21_37, const int *int22_37, const int *internal_loop37,
    const int *bulge37, const int *dangle5_37, const int *dangle3_37,
    int terminal_au37) {
  std::memcpy(g.bp, bp, sizeof(g.bp));
  std::memcpy(g.rtype, rtype, sizeof(g.rtype));
  std::memcpy(g.hairpin, hairpin, sizeof(g.hairpin));
  std::memcpy(g.mismatch_h, mismatch_h, sizeof(g.mismatch_h));
  std::memcpy(g.mismatch_i, mismatch_i, sizeof(g.mismatch_i));
  std::memcpy(g.stack, stack, sizeof(g.stack));
  std::memcpy(g.bulge, bulge, sizeof(g.bulge));
  std::memcpy(g.internal, internal, sizeof(g.internal));
  std::memcpy(g.int11, int11, sizeof(g.int11));
  std::memcpy(g.int21, int21, sizeof(g.int21));
  std::memcpy(g.int22, int22, sizeof(g.int22));
  std::memcpy(g.dangle5, dangle5, sizeof(g.dangle5));
  std::memcpy(g.dangle3, dangle3, sizeof(g.dangle3));
  std::memcpy(g.ninio, ninio, sizeof(g.ninio));
  g.ml_closing = ml_closing;
  g.ml_intern = ml_intern;
  g.ml_base = ml_base;
  g.term_au = term_au;
  g.kT = kT;
  g.lxc = lxc;
  std::memcpy(g.stack37, stack37, sizeof(g.stack37));
  std::memcpy(g.mismatchI37, mismatchI37, sizeof(g.mismatchI37));
  std::memcpy(g.int11_37, int11_37, sizeof(g.int11_37));
  std::memcpy(g.int21_37, int21_37, sizeof(g.int21_37));
  std::memcpy(g.int22_37, int22_37, sizeof(g.int22_37));
  std::memcpy(g.internal_loop37, internal_loop37, sizeof(g.internal_loop37));
  std::memcpy(g.bulge37, bulge37, sizeof(g.bulge37));
  std::memcpy(g.dangle5_37, dangle5_37, sizeof(g.dangle5_37));
  std::memcpy(g.dangle3_37, dangle3_37, sizeof(g.dangle3_37));
  g.terminal_au37 = terminal_au37;
  g.ready = true;
}

// ---------------------------------------------------------------------------
// Accessibility DP ("Raccess"): inside/outside over 7 banded state matrices,
// then per-window unpaired probabilities -> accessibility energies.
// Recurrence semantics match src/raccess.cpp:99-832 exactly (flag-gated
// log-add chains in identical iteration order).
// ---------------------------------------------------------------------------
struct AccessWorkspace {
  // s[i] in 0..4 (1-based; s[0] = 0), banded arrays indexed [i*(W+2) + (j-i)]
  int n = 0, w = 0, stride = 0;
  std::vector<int> s;
  std::vector<double> a_outer, b_outer;
  std::vector<double> a_stem, a_stemend, a_multi, a_multibif, a_multi1,
      a_multi2;
  std::vector<double> b_stem, b_stemend, b_multi, b_multibif, b_multi1,
      b_multi2;

  void reset(const uint8_t *codes, int n_, int w_) {
    n = n_;
    w = w_;
    stride = w + 2;
    s.assign(n + 1, 0);
    for (int i = 0; i < n; i++) s[i + 1] = codes[i];
    const size_t cells = (size_t)(n + 1) * stride;
    a_outer.assign(n + 1, 0.0);
    b_outer.assign(n + 1, 0.0);
    for (auto *v : {&a_stem, &a_stemend, &a_multi, &a_multibif, &a_multi1,
                    &a_multi2, &b_stem, &b_stemend, &b_multi, &b_multibif,
                    &b_multi1, &b_multi2})
      v->assign(cells, NEG_INF);
  }

  double &at(std::vector<double> &m, int i, int j) {
    return m[(size_t)i * stride + (j - i)];
  }
  double rd(const std::vector<double> &m, int i, int j) const {
    return m[(size_t)i * stride + (j - i)];
  }
};

// Interior/stack/bulge loop weight in the scaled (Boltzmann-log) domain
// (reference: src/raccess.cpp:773-817). Positions are 1-based.
static double loop_weight(const std::vector<int> &s, int type, int type2,
                          int i, int j, int p, int q) {
  const int u1 = p - i - 1, u2 = j - q - 1;
  if (u1 == 0 && u2 == 0) return g.stack[type][type2];
  if (u1 == 0 || u2 == 0) {
    const int u = u1 == 0 ? u2 : u1;
    double z = u <= 30
                   ? g.bulge[u]
                   : g.bulge[30] - g.lxc * std::log(u / 30.) * 10. / g.kT;
    if (u == 1) {
      z += g.stack[type][type2];
    } else {
      if (type > 2) z += g.term_au;
      if (type2 > 2) z += g.term_au;
    }
    return z;
  }
  if (u1 + u2 == 2) return g.int11[type][type2][s[i + 1]][s[j - 1]];
  if (u1 == 1 && u2 == 2) return g.int21[type][type2][s[i + 1]][s[q + 1]][s[j - 1]];
  if (u1 == 2 && u2 == 1) return g.int21[type2][type][s[q + 1]][s[i + 1]][s[p - 1]];
  if (u1 == 2 && u2 == 2)
    return g.int22[type][type2][s[i + 1]][s[p - 1]][s[q + 1]][s[j - 1]];
  double z = g.internal[u1 + u2] + g.mismatch_i[type][s[i + 1]][s[j - 1]] +
             g.mismatch_i[type2][s[q + 1]][s[p - 1]];
  return z + g.ninio[std::abs(u1 - u2)];
}

// Hairpin loop weight (reference: src/raccess.cpp:819-832).
static double hairpin_weight(const std::vector<int> &s, int type, int i,
                             int j) {
  const int d = j - i - 1;
  double q = d <= 30
                 ? g.hairpin[d]
                 : g.hairpin[30] - g.lxc * std::log(d / 30.) * 10. / g.kT;
  if (d != 3) {
    q += g.mismatch_h[type][s[i + 1]][s[j - 1]];
  } else if (type > 2) {
    q += g.term_au;
  }
  return q;
}

// Exterior dangle weight (reference: src/raccess.cpp:244-256).
static double dangle_weight(const AccessWorkspace &ws, int type, int a,
                            int b) {
  double x = 0;
  if (type != 0) {
    if (a > 0) x += g.dangle5[type][ws.s[a]];
    if (b < ws.n) x += g.dangle3[type][ws.s[b + 1]];
    if (b == ws.n && type > 2) x += g.term_au;
  }
  return x;
}

// Inside pass (reference: src/raccess.cpp:99-242).
static void inside_pass(AccessWorkspace &ws) {
  const int n = ws.n, W = ws.w;
  const std::vector<int> &s = ws.s;
  for (int j = TURN + 1; j <= n; j++) {
    for (int i = j - TURN; i >= std::max(0, j - W - 1); i--) {
      int type = g.bp[s[i + 1]][s[j]];
      int type2 = g.bp[s[i + 2]][s[j - 1]];

      // stem
      double acc = 0;
      bool got = false;
      if (type != 0) {
        type2 = g.rtype[type2];
        const double inner_stem = ws.rd(ws.a_stem, i + 1, j - 1);
        if (inner_stem != NEG_INF) {
          if (type2 != 0)
            acc = inner_stem + loop_weight(s, type, type2, i + 1, j, i + 2, j - 1);
          got = true;
        }
        const double inner_end = ws.rd(ws.a_stemend, i + 1, j - 1);
        if (inner_end != NEG_INF) {
          acc = got ? log_add(acc, inner_end) : inner_end;
          got = true;
        }
        ws.at(ws.a_stem, i, j) = got ? acc : NEG_INF;
      } else {
        ws.at(ws.a_stem, i, j) = NEG_INF;
      }

      // multibif: split over k (ascending)
      acc = 0;
      got = false;
      for (int k = i + 1; k <= j - 1; k++) {
        const double l = ws.rd(ws.a_multi1, i, k);
        const double r = ws.rd(ws.a_multi2, k, j);
        if (l != NEG_INF && r != NEG_INF) {
          acc = got ? log_add(acc, l + r) : l + r;
          got = true;
        }
      }
      ws.at(ws.a_multibif, i, j) = got ? acc : NEG_INF;

      // multi2
      acc = 0;
      got = false;
      if (type != 0 && ws.rd(ws.a_stem, i, j) != NEG_INF) {
        acc = ws.rd(ws.a_stem, i, j) + g.ml_intern +
              dangle_weight(ws, type, i, j);
        got = true;
      }
      if (ws.rd(ws.a_multi2, i, j - 1) != NEG_INF) {
        double v = ws.rd(ws.a_multi2, i, j - 1) + g.ml_base;
        ws.at(ws.a_multi2, i, j) = got ? log_add(acc, v) : v;
      } else {
        ws.at(ws.a_multi2, i, j) = got ? acc : NEG_INF;
      }

      // multi1 = multi2 (+) multibif
      {
        const double m2 = ws.rd(ws.a_multi2, i, j);
        const double mb = ws.rd(ws.a_multibif, i, j);
        if (m2 != NEG_INF && mb != NEG_INF)
          ws.at(ws.a_multi1, i, j) = log_add(m2, mb);
        else if (m2 == NEG_INF)
          ws.at(ws.a_multi1, i, j) = mb;
        else
          ws.at(ws.a_multi1, i, j) = m2;
      }

      // multi
      {
        const double shift = ws.rd(ws.a_multi, i + 1, j);
        const double mb = ws.rd(ws.a_multibif, i, j);
        if (shift != NEG_INF) {
          double v = shift + g.ml_base;
          ws.at(ws.a_multi, i, j) = mb != NEG_INF ? log_add(v, mb) : v;
        } else {
          ws.at(ws.a_multi, i, j) = mb;
        }
      }

      // stemend: hairpin + interior closings + multiloop close
      if (j != n) {
        type = g.bp[s[i]][s[j + 1]];
        if (type != 0) {
          acc = hairpin_weight(s, type, i, j + 1);
          for (int p = i; p <= std::min(i + MAXLOOP, j - TURN - 2); p++) {
            const int u1 = p - i;
            for (int q = std::max(p + TURN + 2, j - MAXLOOP + u1); q <= j;
                 q++) {
              int t2 = g.bp[s[p + 1]][s[q]];
              if (ws.rd(ws.a_stem, p, q) != NEG_INF && t2 != 0 &&
                  !(p == i && q == j)) {
                t2 = g.rtype[t2];
                acc = log_add(acc, ws.rd(ws.a_stem, p, q) +
                                       loop_weight(s, type, t2, i, j + 1,
                                                   p + 1, q));
              }
            }
          }
          const int tt = g.rtype[type];
          acc = log_add(acc, ws.rd(ws.a_multi, i, j) + g.ml_closing +
                                 g.ml_intern + g.dangle3[tt][s[i + 1]] +
                                 g.dangle5[tt][s[j]]);
          ws.at(ws.a_stemend, i, j) = acc;
        } else {
          ws.at(ws.a_stemend, i, j) = NEG_INF;
        }
      }
    }
  }

  // exterior scan (reference: src/raccess.cpp:231-241)
  for (int i = 1; i <= n; i++) {
    double acc = ws.a_outer[i - 1];
    for (int p = std::max(0, i - W - 1); p < i; p++) {
      if (ws.rd(ws.a_stem, p, i) != NEG_INF) {
        const int type = g.bp[s[p + 1]][s[i]];
        const double ao = ws.rd(ws.a_stem, p, i) + dangle_weight(ws, type, p, i);
        acc = log_add(acc, ao + ws.a_outer[p]);
      }
    }
    ws.a_outer[i] = acc;
  }
}

// Outside pass (reference: src/raccess.cpp:258-412).
static void outside_pass(AccessWorkspace &ws) {
  const int n = ws.n, W = ws.w;
  const std::vector<int> &s = ws.s;

  for (int i = n - 1; i >= 0; i--) {
    double acc = ws.b_outer[i + 1];
    for (int p = i + 1; p <= std::min(i + W + 1, n); p++) {
      if (ws.rd(ws.a_stem, i, p) != NEG_INF) {
        const int type = g.bp[s[i + 1]][s[p]];
        const double bo = ws.rd(ws.a_stem, i, p) + dangle_weight(ws, type, i, p);
        acc = log_add(acc, bo + ws.b_outer[p]);
      }
    }
    ws.b_outer[i] = acc;
  }

  for (int q = n; q >= TURN + 1; q--) {
    for (int p = std::max(0, q - W - 1); p <= q - TURN; p++) {
      double acc = 0;
      if (p != 0 && q != n) {
        // stemend
        ws.at(ws.b_stemend, p, q) =
            q - p >= W ? NEG_INF : ws.rd(ws.b_stem, p - 1, q + 1);

        // multi
        bool got = false;
        if (q - p + 1 <= W + 1 && ws.rd(ws.b_multi, p - 1, q) != NEG_INF) {
          acc = ws.rd(ws.b_multi, p - 1, q) + g.ml_base;
          got = true;
        }
        const int type = g.bp[s[p]][s[q + 1]];
        const int tt = g.rtype[type];
        const double se = ws.rd(ws.b_stemend, p, q);
        if (got) {
          if (se != NEG_INF)
            acc = log_add(acc, se + g.ml_closing + g.ml_intern +
                                   g.dangle3[tt][s[p + 1]] +
                                   g.dangle5[tt][s[q]]);
        } else {
          acc = se != NEG_INF ? se + g.ml_closing + g.ml_intern +
                                    g.dangle3[tt][s[p + 1]] +
                                    g.dangle5[tt][s[q]]
                              : NEG_INF;
        }
        ws.at(ws.b_multi, p, q) = acc;

        // multi1: bif closings to the right (k ascending)
        acc = 0;
        got = false;
        for (int k = q + 1; k <= std::min(n, p + W); k++) {
          const double bb = ws.rd(ws.b_multibif, p, k);
          const double m2 = ws.rd(ws.a_multi2, q, k);
          if (bb != NEG_INF && m2 != NEG_INF) {
            acc = got ? log_add(acc, bb + m2) : bb + m2;
            got = true;
          }
        }
        ws.at(ws.b_multi1, p, q) = got ? acc : NEG_INF;

        // multi2
        acc = 0;
        got = false;
        if (ws.rd(ws.b_multi1, p, q) != NEG_INF) {
          acc = ws.rd(ws.b_multi1, p, q);
          got = true;
        }
        if (q - p <= W && ws.rd(ws.b_multi2, p, q + 1) != NEG_INF) {
          const double v = ws.rd(ws.b_multi2, p, q + 1) + g.ml_base;
          acc = got ? log_add(acc, v) : v;
          got = true;
        }
        for (int k = std::max(0, q - W); k < p; k++) {
          const double bb = ws.rd(ws.b_multibif, k, q);
          const double m1 = ws.rd(ws.a_multi1, k, p);
          if (bb != NEG_INF && m1 != NEG_INF) {
            acc = got ? log_add(acc, bb + m1) : bb + m1;
            got = true;
          }
        }
        ws.at(ws.b_multi2, p, q) = got ? acc : NEG_INF;

        // multibif = multi1 (+) multi
        {
          const double m1 = ws.rd(ws.b_multi1, p, q);
          const double mu = ws.rd(ws.b_multi, p, q);
          if (m1 != NEG_INF && mu != NEG_INF)
            ws.at(ws.b_multibif, p, q) = log_add(m1, mu);
          else if (mu == NEG_INF)
            ws.at(ws.b_multibif, p, q) = m1;
          else
            ws.at(ws.b_multibif, p, q) = mu;
        }
      }

      // stem
      int type2 = g.bp[s[p + 1]][s[q]];
      if (type2 != 0) {
        acc = ws.a_outer[p] + ws.b_outer[q] + dangle_weight(ws, type2, p, q);
        type2 = g.rtype[type2];
        for (int i = std::max(1, p - MAXLOOP); i <= p; i++) {
          for (int j = q; j <= std::min(q + MAXLOOP - p + i, n - 1); j++) {
            const int type = g.bp[s[i]][s[j + 1]];
            if (type != 0 && !(i == p && j == q)) {
              if (j - i <= W + 1 && ws.rd(ws.b_stemend, i, j) != NEG_INF) {
                acc = log_add(acc, ws.rd(ws.b_stemend, i, j) +
                                       loop_weight(s, type, type2, i, j + 1,
                                                   p + 1, q));
              }
            }
          }
        }
        if (p != 0 && q != n) {
          const int type = g.bp[s[p]][s[q + 1]];
          if (type != 0 && q - p + 2 <= W + 1 &&
              ws.rd(ws.b_stem, p - 1, q + 1) != NEG_INF) {
            acc = log_add(acc, ws.rd(ws.b_stem, p - 1, q + 1) +
                                   loop_weight(s, type, type2, p, q + 1, p + 1,
                                               q));
          }
        }
        ws.at(ws.b_stem, p, q) = acc;

        if (ws.rd(ws.b_multi2, p, q) != NEG_INF) {
          type2 = g.rtype[type2];
          const double v = ws.rd(ws.b_multi2, p, q) + g.ml_intern +
                           dangle_weight(ws, type2, p, q);
          ws.at(ws.b_stem, p, q) = log_add(v, ws.rd(ws.b_stem, p, q));
        }
      } else {
        ws.at(ws.b_stem, p, q) = NEG_INF;
      }
    }
  }
}

// P(window unpaired | exterior loop) (reference: src/raccess.cpp:530-534).
static double exterior_prob(const AccessWorkspace &ws, int x, int w) {
  return fast_expd(ws.a_outer[x - 1] + ws.b_outer[x + w - 1] -
                   ws.a_outer[ws.n]);
}

struct ProbVectors {
  std::vector<double> hairpin, cond_hairpin, biloop, cond_biloop;
};

static void hairpin_probability(const AccessWorkspace &ws, int w,
                                ProbVectors &pv) {
  const int n = ws.n, W = ws.w;
  const std::vector<int> &s = ws.s;
  const double pf = ws.a_outer[n];
  for (int x = 1; x + w - 1 <= n; x++) {
    double t = 0.0, ct = 0.0;
    bool got = false, cgot = false;
    for (int i = std::max(1, x - W); i < x; i++) {
      for (int j = x + w; j <= std::min(i + W, n); j++) {
        const int type = g.bp[s[i]][s[j]];
        if (ws.rd(ws.b_stemend, i, j - 1) != NEG_INF) {
          const double h =
              ws.rd(ws.b_stemend, i, j - 1) + hairpin_weight(s, type, i, j);
          if (j == x + w) {
            t = got ? log_add(t, h) : h;
            got = true;
          } else {
            ct = cgot ? log_add(ct, h) : h;
            cgot = true;
          }
        }
      }
    }
    if (got && cgot) t = log_add(t, ct);
    if (!got && cgot) {
      t = ct;
      got = true;
    }
    if (got) pv.hairpin[x - 1] = fast_expd(t - pf);
    if (cgot) pv.cond_hairpin[x - 1] = fast_expd(ct - pf);
  }
}

// Multi-loop unpaired probability for one window
// (reference: src/raccess.cpp:581-612).
static double multi_probability(const AccessWorkspace &ws, int x, int w) {
  const int n = ws.n, W = ws.w;
  double t = 0.0;
  bool got = false;
  for (int i = x + w - 1; i <= std::min(x + W, n); i++) {
    const double bm = ws.rd(ws.b_multi, x - 1, i);
    const double am = ws.rd(ws.a_multi, x + w - 1, i);
    if (bm != NEG_INF && am != NEG_INF) {
      t = got ? log_add(t, bm + am) : bm + am;
      got = true;
    }
  }
  for (int i = std::max(0, x + w - 1 - W); i < x; i++) {
    const double bm2 = ws.rd(ws.b_multi2, i, x + w - 1);
    const double am2 = ws.rd(ws.a_multi2, i, x - 1);
    if (bm2 != NEG_INF && am2 != NEG_INF) {
      t = got ? log_add(t, bm2 + am2) : bm2 + am2;
      got = true;
    }
  }
  return got ? fast_expd(t - ws.a_outer[n]) : 0.0;
}

// Bulge/internal-loop unpaired probabilities, linear-space accumulation
// (reference: src/raccess.cpp:614-681) and log-space fallback (:683-771).
static void biloop_probability(const AccessWorkspace &ws, int w,
                               ProbVectors &pv, bool log_space) {
  const int n = ws.n, W = ws.w;
  const std::vector<int> &s = ws.s;
  const double pf = ws.a_outer[n];
  std::vector<uint8_t> bgot(n, 0), cgot(n, 0);

  for (int i = 1; i < n - TURN - 2; i++) {
    for (int j = i + TURN + 3; j <= std::min(i + W, n); j++) {
      const int type = g.bp[s[i]][s[j]];
      if (type == 0) continue;
      for (int p = i + 1; p <= std::min(i + MAXLOOP + 1, j - TURN - 2); p++) {
        const int u1 = p - i - 1;
        for (int q = std::max(p + TURN + 1, j - MAXLOOP + u1 - 1); q < j;
             q++) {
          int t2 = g.bp[s[p]][s[q]];
          if (t2 == 0 || (p == i + 1 && q == j - 1)) continue;
          t2 = g.rtype[t2];
          if (ws.rd(ws.b_stemend, i, j - 1) == NEG_INF ||
              ws.rd(ws.a_stem, p - 1, q) == NEG_INF)
            continue;
          const double contrib = ws.rd(ws.b_stemend, i, j - 1) +
                                 loop_weight(s, type, t2, i, j, p, q) +
                                 ws.rd(ws.a_stem, p - 1, q);
          const double lin = log_space ? contrib : fast_expd(contrib);
          for (int k = i + 1; k <= p - w; k++) {
            if (k == p - w) {
              if (log_space) {
                pv.biloop[k - 1] =
                    bgot[k - 1] ? log_add(pv.biloop[k - 1], lin) : lin;
                bgot[k - 1] = 1;
              } else {
                pv.biloop[k - 1] += lin;
              }
            } else {
              if (log_space) {
                pv.cond_biloop[k - 1] =
                    cgot[k - 1] ? log_add(pv.cond_biloop[k - 1], lin) : lin;
                cgot[k - 1] = 1;
              } else {
                pv.cond_biloop[k - 1] += lin;
              }
            }
          }
          for (int k = q + 1; k <= j - w; k++) {
            if (k == j - w) {
              if (log_space) {
                pv.biloop[k - 1] =
                    bgot[k - 1] ? log_add(pv.biloop[k - 1], lin) : lin;
                bgot[k - 1] = 1;
              } else {
                pv.biloop[k - 1] += lin;
              }
            } else {
              if (log_space) {
                pv.cond_biloop[k - 1] =
                    cgot[k - 1] ? log_add(pv.cond_biloop[k - 1], lin) : lin;
                cgot[k - 1] = 1;
              } else {
                pv.cond_biloop[k - 1] += lin;
              }
            }
          }
        }
      }
    }
  }

  if (log_space) {
    for (int i = 0; i < n; i++) {
      if (bgot[i] && cgot[i])
        pv.biloop[i] = log_add(pv.biloop[i], pv.cond_biloop[i]);
      if (!bgot[i] && cgot[i]) pv.biloop[i] = pv.cond_biloop[i];
      if (bgot[i]) pv.biloop[i] = fast_expd(pv.biloop[i] - pf);
      if (cgot[i]) pv.cond_biloop[i] = fast_expd(pv.cond_biloop[i] - pf);
    }
  } else {
    for (int i = 0; i < n; i++) {
      if (pv.biloop[i] != 0) {
        pv.biloop[i] =
            fast_logf((float)(pv.biloop[i] + pv.cond_biloop[i]));
        pv.biloop[i] = fast_expd(pv.biloop[i] - pf);
      }
      if (pv.cond_biloop[i] != 0) {
        pv.cond_biloop[i] = fast_logf((float)pv.cond_biloop[i]);
        pv.cond_biloop[i] = fast_expd(pv.cond_biloop[i] - pf);
      }
    }
  }
}

// Full accessibility computation for one sequence. `codes` are 0..4
// (0 = unknown, 1..4 = ACGU; lowercase letters map like uppercase,
// reference: src/raccess.cpp:52-68). Outputs:
//   acc[0 .. n-d]                      window accessibilities (kcal/mol)
//   cond[d .. n-1] (first d zeros)     conditional accessibilities
// matching the in-memory variant (reference: src/raccess.cpp:484-528).
// Debug/validation: run inside+outside and dump all 12 banded state
// matrices plus the outer arrays ((n+1) x (w+2) each, row-major [i][span]).
extern "C" int rp_raccess_dump(const uint8_t *codes, int n, int w_span,
                               double *out) {
  if (!g.ready) return -1;
  thread_local AccessWorkspace ws;
  ws.reset(codes, n, w_span);
  inside_pass(ws);
  outside_pass(ws);
  const size_t cells = (size_t)(n + 1) * (w_span + 2);
  double *p = out;
  for (const auto *v :
       {&ws.a_stem, &ws.a_stemend, &ws.a_multi, &ws.a_multibif, &ws.a_multi1,
        &ws.a_multi2, &ws.b_stem, &ws.b_stemend, &ws.b_multi, &ws.b_multibif,
        &ws.b_multi1, &ws.b_multi2}) {
    std::memcpy(p, v->data(), cells * sizeof(double));
    p += cells;
  }
  std::memcpy(p, ws.a_outer.data(), (n + 1) * sizeof(double));
  p += n + 1;
  std::memcpy(p, ws.b_outer.data(), (n + 1) * sizeof(double));
  return 0;
}

extern "C" int rp_raccess(const uint8_t *codes, int n, int w_span, int d,
                          float *acc, float *cond) {
  if (!g.ready) return -1;
  thread_local AccessWorkspace ws;
  ws.reset(codes, n, w_span);
  inside_pass(ws);
  outside_pass(ws);

  ProbVectors pv;
  pv.hairpin.assign(n, 0.0);
  pv.cond_hairpin.assign(n, 0.0);
  pv.biloop.assign(n, 0.0);
  pv.cond_biloop.assign(n, 0.0);

  const double pf = ws.a_outer[n];
  const bool log_space = !(pf >= -690 && pf <= 690);
  biloop_probability(ws, d, pv, log_space);
  hairpin_probability(ws, d, pv);

  for (int i = 0; i < n; i++) {
    acc[i] = 0.0f;
    cond[i] = 0.0f;
  }
  for (int x = 1; x + d - 1 <= n; x++) {
    double prob = 0.0;
    prob += exterior_prob(ws, x, d);
    prob += pv.hairpin[x - 1];
    prob += pv.biloop[x - 1];
    prob += multi_probability(ws, x, d);
    acc[x - 1] = (float)((-fast_logf((float)prob) * g.kT) / 1000);
  }
  for (int x = 1; x + d - 1 < n; x++) {
    double prob = 0.0;
    prob += exterior_prob(ws, x, d + 1);
    prob += pv.cond_hairpin[x - 1];
    prob += pv.cond_biloop[x - 1];
    prob += multi_probability(ws, x, d + 1);
    cond[x + d - 1] =
        (float)((-fast_logf((float)prob) * g.kT) / 1000 - acc[x - 1]);
  }
  return 0;
}

}  // namespace rp
