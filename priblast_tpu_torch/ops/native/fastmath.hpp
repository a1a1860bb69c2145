// Table-driven fast exp/log (herumi/fmath algorithm) — the approximations the
// reference's energies flow through (reference: src/fmath.hpp:400-470,738-752).
// Fresh implementation of the published algorithm; tables are rebuilt here
// with libm at startup exactly as the reference builds them during static
// initialization, so results are bit-identical.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>

namespace rp {

struct FastMathTables {
  static constexpr int kExpdBits = 11;
  static constexpr int kExpdSize = 1 << kExpdBits;
  static constexpr uint64_t kExpdAdj =
      (1ULL << (kExpdBits + 10)) - (1ULL << kExpdBits);
  static constexpr int kLogBits = 11;
  static constexpr int kLogSize = 1 << kLogBits;

  uint64_t expd_tbl[kExpdSize];
  float log_app[kLogSize];
  float log_rev[kLogSize];
  float c_log2;
  double expd_a, expd_ra;

  FastMathTables() {
    expd_a = kExpdSize / std::log(2.0);
    expd_ra = 1.0 / expd_a;
    for (int i = 0; i < kExpdSize; i++) {
      double d = std::pow(2.0, i * (1.0 / kExpdSize));
      uint64_t bits;
      std::memcpy(&bits, &d, 8);
      expd_tbl[i] = bits & ((1ULL << 52) - 1);
    }
    const double e = 1.0 / double(1 << 24);
    const double h = 1.0 / double(kLogSize);
    for (int i = 0; i < kLogSize; i++) {
      double x = 1 + double(i) / kLogSize;
      double a = std::log(x);
      log_app[i] = (float)a;
      if (i < kLogSize - 1) {
        double b = std::log(x + h - e);
        log_rev[i] = (float)((b - a) / ((h - e) * (1 << 23)));
      } else {
        log_rev[i] = (float)(1 / (x * (1 << 23)));
      }
    }
    c_log2 = std::log(2.0f) / (1 << 23);
  }
};

inline const FastMathTables &fm_tables() {
  static FastMathTables t;
  return t;
}

// Double-precision exp: 11-bit 2^frac table + cubic correction.
inline double fast_expd(double x) {
  if (x <= -708.39641853226408) return 0;
  if (x >= 709.78271289338397) return std::numeric_limits<double>::infinity();
  const FastMathTables &c = fm_tables();
  const double b = double(3ULL << 51);
  const double d = x * c.expd_a + b;
  uint64_t dbits;
  std::memcpy(&dbits, &d, 8);
  // low 32 bits, sign-extended into a uint64 (matches the reference's
  // _mm_cvtsi128_si32 read of the double's low lane)
  uint64_t di = (uint64_t)(int64_t)(int32_t)(uint32_t)(dbits & 0xFFFFFFFFu);
  const uint64_t iax = c.expd_tbl[di & (FastMathTables::kExpdSize - 1)];
  const double t = (d - b) * c.expd_ra - x;
  uint64_t u = ((di + FastMathTables::kExpdAdj) >> FastMathTables::kExpdBits)
               << 52;
  const double y = (3.0000000027955394 - t) * (t * t) *
                       0.16666666685227835064 -
                   t + 1.0;
  u |= iax;
  double frac;
  std::memcpy(&frac, &u, 8);
  return y * frac;
}

// Single-precision log via 11-bit mantissa table.
inline float fast_logf(float x) {
  const FastMathTables &c = fm_tables();
  uint32_t i;
  std::memcpy(&i, &x, 4);
  const int a = (int)(i & (0xFFu << 23));
  const uint32_t b2 = i & ((1u << (23 - FastMathTables::kLogBits)) - 1);
  const int idx = (i >> (23 - FastMathTables::kLogBits)) &
                  (FastMathTables::kLogSize - 1);
  return (float)(a - (127 << 23)) * c.c_log2 + c.log_app[idx] +
         (float)b2 * c.log_rev[idx];
}

// Pairwise log-add in the reference's exact formulation
// (reference: src/raccess.cpp:414-419).
inline double log_add(double x, double y) {
  return x > y ? x + (double)fast_logf((float)(fast_expd(y - x) + 1.0))
               : y + (double)fast_logf((float)(fast_expd(x - y) + 1.0));
}

}  // namespace rp
