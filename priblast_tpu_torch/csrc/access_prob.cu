// The accessibility DP's probability pass for Hopper (sm_90a): from the
// inside and outside planes, the unpaired probability of every window of
// size w and w + 1, p_w and p_w1 [N+2][B], in two launches behind one C
// entry point.
//
// Replaces the XLA program of the JAX package that computes these sums:
// priblast_tpu/accessibility/batched.py:make_prob_grids (:1111) and
// probability_pass (:1175), summed at :1370-1371. Reference semantics:
// src/raccess.cpp:421-681. The terms follow the plain PyTorch version,
// priblast_tpu_torch/accessibility/batched.py:scan_probabilities
// (make_prob_grids, probability_pass and the sum), one for one; only the
// order in which some sums add their terms differs (every term is a
// nonnegative weight), and the contractions' multiply-adds are fused.
// Build with -fmad=false, as the other kernels.
//
// Layout: every plane is [N+1][B][band] (column c leading, span e last),
// A and B [N+1][B], the codes [B][S] (1-based, zero padded), p_w and p_w1
// [N+2][B] indexed by the 1-based window start x.
//
// Rows are independent: every shift of the plain version moves along a
// row's own columns or span cells, so a row is never split over CTAs by a
// reduction. Every sum has a fixed order per row (no atomics), and a row
// gets the same bits in any batch.
//
// Bound on this card: ~50k multiply-adds per (column, row) at w = 5, most
// of them the interior loops' two contractions, against eleven planes
// read once: the operations bound it (chip_smoke.py prob_ops_per_row).
// Two launches:
//   A. window_kernel: a CTA per (row b, tile of columns); a warp takes 4
//      columns at once, 8 lanes each. For each loop size u = w .. ML in
//      turn (the same u on every lane) and each side it computes
//      - srcR[u][c] = sum_j bse_m[c][u+j] h(j), h(j) = sum_t
//        stem_m[c-u][j-t] K[t][u] (t = 1 .. min(ML-u, j)), plus
//        Kb[u] sum_j bse_a[c][u+j] stem_a[c-u][j] (+ the small-loop
//        specials where w <= 2): the loops whose right side has u unpaired
//        bases, indexed by the closing column;
//      - srcL[u][c] likewise for the left side, indexed by the left end c
//        of the closing pair: the same sums on the diagonals r - k = c + u
//        of stem_m and stem_a, the outer cells bse_m[c+u+j][u+j];
//      then the hairpin suffix sums SS[o][c] = sum_{e >= o} bse hpW (one
//      descending float64 pass, the plain version's order and precision)
//      and the running sums of srcL / srcR over u that the conditional
//      windows read, into a scratch buffer [K][N+1][B].
//   B. sum_kernel: a thread per (window x, row b): the exterior term, the
//      hairpin and multiloop gathers at shifted columns, the boundary and
//      conditional sums of srcL / srcR, the linear / log branch (the clamp
//      at e^(128 ln 2 - logZ) and the conditional part dropped where the
//      boundary sum is 0, only where |logZ| <= 690), then p_w and p_w1.
// What the window kernel does about its time (its parts timed by
// access_ab.py with -DACCESS_STAMPS):
// - even work per lane: a (u, side) sum is the 1-D convolution of a stem
//   row (or diagonal) with the column K[.][u], then a dot product with the
//   outer cells. Its spans j = 0 .. band-1-u are cut into 8 blocks of J
//   consecutive spans (J odd, the least that covers them, at most 9; past
//   72 spans a lane takes blocks blk, blk + 8, ...), one block per lane of
//   the column, so every lane runs the same min(ML-u, .) steps; the
//   bulge's spans go to the lanes in turn (j = blk, blk + 8, ...);
// - several sums per lane and one load for several multiply-adds: a lane
//   keeps its block's J partial sums h(j) of both sides and a sliding
//   window of J stem values per side in registers (the t loop is
//   unrolled, so the windows slide by renaming, and leaves only every
//   kStep steps, so that a group of steps issues its loads together);
//   each step loads one stem value and one K value (the same address on
//   every lane) per side for J fused multiply-adds (fmaf / fma, FFMA even
//   under -fmad=false);
// - a fixed order: a lane adds its terms in ascending t, then ascending j,
//   then its bulge times Kb[u], then (w <= 2) the specials; the 8 lanes'
//   sums of 4 loop sizes meet through shared memory in a fixed tree. The
//   split depends only on (w, band, ML), never on the tile, the column's
//   place, the batch or its padding, so a row gets the same bits in any
//   batch;
// - shared memory: the stem_m and stem_a rows a tile reads (its columns,
//   ML before, band after; loaded 8 elements a thread at a time), the K
//   tables and, per warp, four band-long rows of its 4 columns (bse_m and
//   bse_a of the column and of its diagonal), the lanes' sums (then the
//   columns' bse hpW rows) and the 64 sums of each column: 111.8 KB at 32
//   columns of float32, two CTAs of 128 threads to an SM. Row strides are
//   8 mod 32 elements, so that with J odd the 32 lanes of a step read 32
//   distinct banks. A warp's first rows are loaded before the CTA's
//   staging barrier, so the two share one round trip;
// - rows that do not fit (a wide band) are read from device memory by the
//   same code (kStaged = false), with the same bits.
// The small-loop weights (w <= 2 only) are computed from the characters
// and the int11 / int21 / int22 / stack tables (read through L1), so the
// kernel never reads a weight grid.
//
// A third kernel, epilogue_kernel (C below), turns p_w and p_w1 into the
// window energies behind its own entry points.
//
// C entry points (ctypes): access_prob_f32, access_prob_f64 (the two
// launches above), access_epilogue_f32, access_epilogue_f64 (the
// epilogue). They launch on the given stream and return
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kML = 30;          // thermo.MAXLOOP, the tables' size
constexpr int kKS = 32;          // row stride of the K tables in shared memory
constexpr int kMaxThreads = 1024;
constexpr int kWindowMaxThreads = 256;  // threads per CTA of window_kernel
constexpr int kSumThreads = 256;  // threads per block of sum_kernel
constexpr int kEpilogueThreads = 256;  // threads per block of epilogue_kernel

template <typename T>
struct Params {
  const T *stem, *stem_m, *stem_a, *multi, *multi2;   // inside planes
  const T *bse, *bse_m, *bse_a, *b_multi, *b_multi2;  // outside planes
  const T *hpW, *A, *Bo, *logZ;
  const int64_t *codes;
  const T *KI, *Kb;         // KI[u1][u2] (ML+1)^2, Kb[u] ML+1, in T
  const int *bp, *rtbp;     // 5 x 5
  const float *stack, *i11, *i21, *i22;
  T *scr, *p_w, *p_w1;
  long long n1, B, S;
  int band, w, tile, nss, nu, nt, S2;
  T sig[5];                 // sigma^-k, k = 0..4, each rounded to T
  T sigf[2];                // sigma^-w, sigma^-(w+1)
  T c128;                   // 128 ln 2 (rounded as the plain version)
  float b1;                 // bulge-length weight of one unpaired base
};

__host__ __device__ inline long long ceil_div(long long a, long long b) {
  return (a + b - 1) / b;
}

__device__ inline float ex(float v) { return expf(v); }
__device__ inline double ex(double v) { return exp(v); }

template <typename T>
__device__ inline T smaller(T a, T b) { return b < a ? b : a; }

// scratch slots: SS[o] at o - w; srcL[u] at nss + u - w; the left running
// sums RL[t] (t = 1..ML-w) at nss + nu + t - 1; the right ones RR[tau]
// (tau = w+1..ML) at nss + nu + nt + tau - w - 1; sum_u srcR[u] last
template <typename T>
__device__ inline T *slot(const Params<T> &p, int k, long long c,
                          long long b) {
  return p.scr + ((long long)k * p.n1 + c) * p.B + b;
}

// The small-loop weight k = 0..5 of the specials (1,0), (0,1), (1,1),
// (1,2), (2,1), (2,2) at the outer cell (column jc, span e) of row b, as
// batched.py:make_prob_grids forms it: the closing pair (i, j) = (jc - e,
// jc + 1), the table value in float32, masked where (i, j) cannot pair,
// then rounded to T and times sigma^-(u1+u2).
template <typename T>
__device__ T special_weight(const Params<T> &p, int k, long long jc, int e,
                            long long b) {
  const int64_t *s = p.codes + b * p.S;
  auto at = [&](long long pos) -> int {
    return pos >= 0 && pos < p.S ? (int)s[pos] : 0;
  };
  const long long i = jc - e;
  const int si = at(i), si1 = at(i + 1), si2 = at(i + 2), si3 = at(i + 3);
  const int sj = at(jc + 1), sjm1 = at(jc), sjm2 = at(jc - 1),
            sjm3 = at(jc - 2);
  const int tc = p.bp[si * 5 + sj];
  if (tc == 0) return T(0);
  auto rt = [&](int a, int c) { return p.rtbp[a * 5 + c]; };
  float v;
  int n;
  switch (k) {
    case 0:
      v = p.b1 * __ldg(p.stack + tc * 7 + rt(si2, sjm1));
      n = 1;
      break;
    case 1:
      v = p.b1 * __ldg(p.stack + tc * 7 + rt(si1, sjm2));
      n = 1;
      break;
    case 2:
      v = __ldg(p.i11 + ((tc * 8 + rt(si2, sjm2)) * 5 + si1) * 5 + sjm1);
      n = 2;
      break;
    case 3:
      v = __ldg(p.i21 + (((tc * 8 + rt(si2, sjm3)) * 5 + si1) * 5 + sjm2) * 5
                + sjm1);
      n = 3;
      break;
    case 4:
      v = __ldg(p.i21 + (((rt(si3, sjm2) * 8 + tc) * 5 + sjm1) * 5 + si1) * 5
                + si2);
      n = 3;
      break;
    default:
      v = __ldg(p.i22 + ((((tc * 8 + rt(si3, sjm3)) * 5 + si1) * 5 + si2) * 5
                         + sjm2) * 5 + sjm1);
      n = 4;
      break;
  }
  return T(v) * p.sig[n];
}

// (u1, u2) of the specials, in the plain version's order
__device__ constexpr int kSpU1[6] = {1, 0, 1, 1, 2, 2};
__device__ constexpr int kSpU2[6] = {0, 1, 1, 2, 1, 2};

#ifdef ACCESS_STAMPS
// A build with -DACCESS_STAMPS (access_ab.py; never the wrapper's) splits
// each warp's time in window_kernel by part: lane 0's SM cycles since the
// warp's previous mark, summed over the warps of every CTA, and the
// columns the warps took; access_prob_stamps reads and clears the sums.
constexpr int kStages = 6;  // staging, load, interior, bulge, reduce, tail
__device__ unsigned long long g_stamps[2 * kStages + 1];

struct Stamps {
  long long prev, sum[kStages];

  __device__ void start() {
    prev = clock64();
    for (int s = 0; s < kStages; ++s) sum[s] = 0;
  }
  __device__ void mark(int s) {
    const long long t = clock64();
    sum[s] += t - prev;
    prev = t;
  }
  __device__ void finish(long long cols) {
    if ((threadIdx.x & 31) != 0) return;
    for (int s = 0; s < kStages; ++s)
      atomicAdd(&g_stamps[s], (unsigned long long)sum[s]);
    atomicAdd(&g_stamps[2 * kStages], (unsigned long long)cols);
  }
};
#define STAMP(s) st.mark(s)
#else
#define STAMP(s)
#endif

// A warp takes kCols columns at once, kLanes lanes each; a lane's block
// of a (u, side) sum holds at most kMaxJ consecutive spans
constexpr int kCols = 4;
constexpr int kLanes = 32 / kCols;
constexpr int kMaxJ = 9;
constexpr int kStep = 4;  // steps of a lane's t loop between exit tests

// shared memory, in elements of T: the K tables KR[t][u] = K[t][u] and
// KL[t][u] = K[u][t] (rows of kKS, zero where t + u > ML), Kb; per warp
// the four band-long rows of its kCols columns (row kind r of column g at
// (r * kCols + g) * S2: bse_m, bse_a, bse_m and bse_a of the column's
// diagonal), a scratch area (the lanes' sums of a batch of loop sizes,
// then the columns' bse hpW rows) and the 64 sums of each column; then the
// staged stem_m and stem_a rows
__host__ __device__ inline int tables_size() {
  return 2 * (kML + 1) * kKS + kKS;
}
__host__ __device__ inline int scratch_size(int S2) {
  const int sums = kLanes * kCols * (kLanes + 1);
  return kCols * S2 > sums ? kCols * S2 : sums;
}
__host__ __device__ inline int warp_size(int S2) {
  return 4 * kCols * S2 + scratch_size(S2) + 64 * kCols;
}
__host__ __device__ inline int staged_rows(int tile, int band) {
  return tile + band - 1 + kML;
}

// spans per lane's block of a sum over n1 spans: the least odd J with
// kLanes * J >= n1, at most kMaxJ (odd, so that the 32 lanes of a step
// read 32 distinct banks with row strides of 8 mod 32)
__host__ __device__ inline int block_spans(int n1) {
  int J = (n1 + kLanes - 1) / kLanes;
  J += J % 2 == 0;
  return J < kMaxJ ? J : kMaxJ;
}

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

// One lane's block of a loop size's two interior sums, the spans j = jb ..
// jb + J - 1 of each side: h(j) = sum_{t=1}^{Tu} x(j - t) K(t), with x(k) =
// xr[k] for 0 <= k <= limr (right) or xl[k * xs] for 0 <= k <= liml (left),
// else 0, and K(t) = Kr[t * kKS] or Kl[t * kKS], each h(j) a sum of its
// own in ascending t; adds yr[j] h(j) over the spans 1 <= j <= jr to pr,
// and yl[j] h(j) over 1 <= j <= jl to pl, in ascending j. The windows of
// J stem values slide by renaming (the t loop is unrolled): two stem loads
// and two K loads per 2J multiply-adds. The loop leaves only every kStep
// steps, so that a step group's loads issue together; the steps past Tu
// read K(t) = 0 (the tables are zero where t + u > ML) and add exact
// zeros.
template <int J, typename T>
__device__ __forceinline__ void interior(const T *xr, const T *xl, int xs,
                                         int limr, int liml, const T *Kr,
                                         const T *Kl, int Tu, const T *yr,
                                         const T *yl, int jb, int jr, int jl,
                                         T &pr, T &pl) {
  T wr[J], wl[J], hr[J], hl[J];
#pragma unroll
  for (int q = 0; q < J; ++q) {
    const int k = jb + q - 1;
    wr[q] = (unsigned)k <= (unsigned)limr ? xr[k] : T(0);
    wl[q] = (unsigned)k <= (unsigned)liml ? xl[k * xs] : T(0);
    hr[q] = hl[q] = T(0);
  }
#pragma unroll
  for (int t = 1; t < kML; ++t) {
    if (t % kStep == 1 && t > Tu) break;
    if (t > 1) {
#pragma unroll
      for (int q = J - 1; q > 0; --q) {
        wr[q] = wr[q - 1];
        wl[q] = wl[q - 1];
      }
      const int k = jb - t;
      wr[0] = (unsigned)k <= (unsigned)limr ? xr[k] : T(0);
      wl[0] = (unsigned)k <= (unsigned)liml ? xl[k * xs] : T(0);
    }
    const T kr = Kr[t * kKS], kl = Kl[t * kKS];
#pragma unroll
    for (int q = 0; q < J; ++q) {
      hr[q] = fmadd(wr[q], kr, hr[q]);
      hl[q] = fmadd(wl[q], kl, hl[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < J; ++q) {
    const int j = jb + q;
    if (j >= 1 && j <= jr) pr = fmadd(yr[j], hr[q], pr);
    if (j >= 1 && j <= jl) pl = fmadd(yl[j], hl[q], pl);
  }
}

// A lane's share of a loop size's two interior sums over the spans 0 ..
// n1 - 1: its blocks blk, blk + kLanes, ... of J = block_spans(n1) spans,
// in turn
template <int J, typename T>
__device__ __forceinline__ void interior_rounds(
    const T *xr, const T *xl, int xs, int limr, int liml, const T *Kr,
    const T *Kl, int Tu, const T *yr, const T *yl, int blk, int n1, int jr,
    int jl, T &pr, T &pl) {
  for (int jb = blk * J; jb < n1; jb += kLanes * J)
    interior<J>(xr, xl, xs, limr, liml, Kr, Kl, Tu, yr, yl, jb, jr, jl, pr,
                pl);
}

template <typename T>
__device__ __forceinline__ void interior_sums(
    const T *xr, const T *xl, int xs, int limr, int liml, const T *Kr,
    const T *Kl, int Tu, const T *yr, const T *yl, int blk, int n1, int jr,
    int jl, T &pr, T &pl) {
#define ROUNDS(J)                                                          \
  interior_rounds<J>(xr, xl, xs, limr, liml, Kr, Kl, Tu, yr, yl, blk, n1, \
                     jr, jl, pr, pl)
  switch (block_spans(n1)) {
    case 1: ROUNDS(1); break;
    case 3: ROUNDS(3); break;
    case 5: ROUNDS(5); break;
    case 7: ROUNDS(7); break;
    default: ROUNDS(kMaxJ); break;
  }
#undef ROUNDS
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kWindowMaxThreads)
    window_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T *sm = reinterpret_cast<T *>(smem);
  const int band = p.band, w = p.w, S2 = p.S2, lane = threadIdx.x & 31,
            warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane / kLanes, blk = lane % kLanes;  // column, block
  const long long B = p.B, N = p.n1 - 1;
  const long long b = blockIdx.x % B;
  const long long c0 = (long long)(blockIdx.x / B) * p.tile;
  const long long c1 = c0 + p.tile < p.n1 ? c0 + p.tile : p.n1;
  const long long r0 = c0 - kML;  // first staged row
  const int ngroups = (int)((c1 - c0 + kCols - 1) / kCols);

  T *KR = sm, *KL = KR + (kML + 1) * kKS, *Kbs = KL + (kML + 1) * kKS;
  T *wb = Kbs + kKS + warp * warp_size(S2);
  const T *bmr = wb + g * S2, *bar = wb + (kCols + g) * S2,
          *bml = wb + (2 * kCols + g) * S2, *bal = wb + (3 * kCols + g) * S2;
  T *sums = wb + 4 * kCols * S2, *hp = sums + g * S2;
  T *tot = sums + scratch_size(S2) + 64 * g;  // srcR[u], then srcL[u] at 32 +
  T *stm = sm + tables_size() + nwarps * warp_size(S2);
  T *sta = stm + (long long)staged_rows(p.tile, band) * S2;

  // the four rows of the columns of group grp, each by its column's lanes
  auto load_rows = [&](int grp) {
    const long long c = c0 + (long long)grp * kCols + g;
#pragma unroll 3
    for (int e = blk; e < band; e += kLanes) {
      T v[4] = {T(0), T(0), T(0), T(0)};
      if (c < c1) {
        const long long gi = (c * B + b) * band + e;
        v[0] = p.bse_m[gi];
        v[1] = p.bse_a[gi];
        if (c + e <= N) {
          const long long gd = ((c + e) * B + b) * band + e;
          v[2] = p.bse_m[gd];
          v[3] = p.bse_a[gd];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) wb[(r * kCols + g) * S2 + e] = v[r];
    }
  };
#ifdef ACCESS_STAMPS
  Stamps st;
  st.start();
  long long cols = 0;
#endif
  if (warp < ngroups) load_rows(warp);  // with the staging, one round trip

#pragma unroll 8
  for (int i = threadIdx.x; i < (kML + 1) * kKS; i += blockDim.x) {
    const int a = i / kKS, c = i % kKS;
    KR[i] = a + c <= kML ? p.KI[a * (kML + 1) + c] : T(0);
    KL[i] = a + c <= kML ? p.KI[c * (kML + 1) + a] : T(0);
  }
  for (int i = threadIdx.x; i < kKS; i += blockDim.x)
    Kbs[i] = i <= kML ? p.Kb[i] : T(0);
  if (kStaged) {  // kBatch elements a thread at a time, loads first
    constexpr int kBatch = 8;
    const int n = staged_rows(p.tile, band) * band, nt = blockDim.x;
    for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * nt) {
      T vm[kBatch], va[kBatch];
#pragma unroll
      for (int m = 0; m < kBatch; ++m) {
        const int i = i0 + m * nt, r = i / band;
        const long long gr = r0 + r;
        const long long gi = (gr * B + b) * band + (i - r * band);
        const bool in = i < n && gr >= 0 && gr <= N;
        vm[m] = in ? p.stem_m[gi] : T(0);
        va[m] = in ? p.stem_a[gi] : T(0);
      }
#pragma unroll
      for (int m = 0; m < kBatch; ++m) {
        const int i = i0 + m * nt, r = i / band, k = i - r * band;
        if (i < n) {
          stm[r * S2 + k] = vm[m];
          sta[r * S2 + k] = va[m];
        }
      }
    }
  }
  __syncthreads();

  // row r of stem_m / stem_a, for r0 <= r <= N and r < c1 + band - 1; the
  // step along a diagonal (row and span up by one)
  auto sm_row = [&](long long r) -> const T * {
    return kStaged ? stm + (r - r0) * S2 : p.stem_m + (r * B + b) * band;
  };
  auto sa_row = [&](long long r) -> const T * {
    return kStaged ? sta + (r - r0) * S2 : p.stem_a + (r * B + b) * band;
  };
  STAMP(0);
  const int diag = kStaged ? S2 + 1 : (int)(B * band + 1);
  // read by lanes with no terms
  const T *safe = kStaged ? stm : p.stem_m, *safe_a = kStaged ? sta : p.stem_a;

  for (int grp = warp; grp < ngroups; grp += nwarps) {
    const long long c = c0 + (long long)grp * kCols + g;
    const bool active = c < c1;
    __syncwarp();  // the group's rows are in place
#ifdef ACCESS_STAMPS
    cols += c1 - (c - g) < kCols ? c1 - (c - g) : kCols;
#endif

    // kLanes / 2 loop sizes u0 + i at a time: each lane's sums of srcR[u]
    // and srcL[u] go to v[2i] and v[2i + 1], then through shared memory to
    // lane 2i (srcR) and 2i + 1 (srcL) of the column, which adds the
    // column's kLanes sums in a fixed tree
    T v[kLanes] = {};
    for (int u0 = w; u0 <= kML; u0 += kLanes / 2) {
#pragma unroll 1
      for (int u = u0; u < u0 + kLanes / 2; ++u) {
        const int n = band - 1 - u;  // the spans j = 0 .. n (u + j < band)
        const int Tu = kML - u;
        T pr = T(0), pl = T(0);
        if (u <= kML && n >= 0) {
          // each side's last span: the right side needs c >= u, the left one
          // c + u + j <= N
          const long long nl = N - c - u;
          const int jr = active && c >= u ? n : -1;
          const int jl = !active || nl < 0 ? -1 : (int)(nl < n ? nl : n);
          STAMP(4);
          if (Tu > 0)
            interior_sums(jr >= 1 ? sm_row(c - u) : safe,
                          jl >= 1 ? sm_row(c + u) : safe, diag,
                          jr >= 1 ? jr - 1 : 0, jl >= 1 ? jl - 1 : 0, KR + u,
                          KL + u, Tu, bmr + u, bml + u, blk, n + 1, jr, jl,
                          pr, pl);
          STAMP(2);
          if (u >= 2) {  // the bulges, spans j = blk, blk + kLanes, ...
            T br = T(0), bl = T(0);
            const T *xr = jr >= 0 ? sa_row(c - u) : safe_a,
                    *xl = jl >= 0 ? sa_row(c + u) : safe_a;
            const int jm = jr > jl ? jr : jl;
            for (int j0 = blk; j0 <= jm; j0 += kLanes * kMaxJ)
#pragma unroll
              for (int m = 0; m < kMaxJ; ++m) {
                const int j = j0 + m * kLanes;
                if (j <= jr) br = fmadd(bar[u + j], xr[j], br);
                if (j <= jl) bl = fmadd(bal[u + j], xl[j * diag], bl);
              }
            pr = fmadd(Kbs[u], br, pr);
            pl = fmadd(Kbs[u], bl, pl);
          }
          // the small-loop specials (w <= 2 only), in the plain version's
          // order, into srcR[u2] and srcL[u1]; spans e = u1 + u2 + blk, ...
          for (int k = 0; k < 6 && u <= 2; ++k) {
            const int u1 = kSpU1[k], u2 = kSpU2[k];
            if (u2 == u && jr >= 0)
              for (int e = u1 + u2 + blk; e < band; e += kLanes) {
                const long long gi = (c * B + b) * band + e;
                pr = fmadd(p.bse[gi] * special_weight(p, k, c, e, b),
                           p.stem[((c - u2) * B + b) * band + e - u1 - u2],
                           pr);
              }
            if (u1 == u && active)
              for (int e = u1 + u2 + blk; e < band && c + e <= N;
                   e += kLanes) {
                const long long gi = ((c + e) * B + b) * band + e;
                const long long gs = ((c + e - u2) * B + b) * band + e - u1 -
                                     u2;
                pl = fmadd(p.bse[gi] * special_weight(p, k, c + e, e, b),
                           p.stem[gs], pl);
              }
          }
          STAMP(3);
        }
#pragma unroll
        for (int k = 0; k + 2 < kLanes; ++k) v[k] = v[k + 2];
        v[kLanes - 2] = pr;
        v[kLanes - 1] = pl;
      }
#pragma unroll
      for (int i = 0; i < kLanes; ++i)
        sums[(i * kCols + g) * (kLanes + 1) + blk] = v[i];
      __syncwarp();
      const T *q = sums + (blk * kCols + g) * (kLanes + 1);
      T a[kLanes];
#pragma unroll
      for (int l = 0; l < kLanes; ++l) a[l] = q[l];
#pragma unroll
      for (int half = kLanes / 2; half >= 1; half >>= 1)
#pragma unroll
        for (int i = 0; i < half; ++i) a[i] = a[2 * i] + a[2 * i + 1];
      const int u = u0 + blk / 2;
      if (u <= kML) tot[(blk & 1) * 32 + u - w] = a[0];
      __syncwarp();
      STAMP(4);
    }
    // the columns' bse hpW rows, into the scratch area
    for (int e = blk; e < band; e += kLanes) {
      const long long gi = (c * B + b) * band + e;
      hp[e] = active ? p.bse[gi] * p.hpW[gi] : T(0);
    }
    __syncwarp();

    // a lane each: the running sums of srcL and of srcR in descending u
    // from ML (the plain version's order), the latter on to u = w for the
    // sum of srcR; the hairpin suffix sums in one descending float64 pass
    // (the plain version's order and precision); srcL[u] by the other
    // lanes
    if (active) {
      if (blk < 2) {
        const T *src = blk == 0 ? tot + 32 : tot;
        const int base = p.nss + p.nu + (blk == 0 ? 0 : p.nt);
        T run = T(0);
#pragma unroll 4
        for (int u = kML; u > w; --u) {
          run = run + src[u - w];
          *slot(p, base + u - w - 1, c, b) = run;
        }
        if (blk == 1)
          *slot(p, p.nss + p.nu + 2 * p.nt, c, b) =
              p.nu > 0 ? run + tot[0] : T(0);
      } else if (blk == 2) {
        double run = 0.0;
#pragma unroll 8
        for (int e = band - 1; e >= w; --e) {
          run = run + (double)hp[e];
          if (e <= band - 2) *slot(p, e - w, c, b) = (T)run;
        }
      } else {
        for (int i = blk - 3; i < p.nu; i += kLanes - 3)
          *slot(p, p.nss + i, c, b) = tot[32 + i];
      }
    }
    __syncwarp();  // the rows and sums are read
    STAMP(5);
    if (grp + nwarps < ngroups) load_rows(grp + nwarps);
    STAMP(1);
  }
#ifdef ACCESS_STAMPS
  st.finish(cols);
#endif
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) sum_kernel(const Params<T> p) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long B = p.B, N = p.n1 - 1;
  if (idx >= (N + 2) * B) return;
  const long long x = idx / B, b = idx % B;
  T pw = T(0), pw1 = T(0);
  if (x <= N) {
    const int w = p.w, band = p.band, W = band - 2;
    const T lz = p.logZ[b];
    T ext[2], mp[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int wsz = w + i;
      // exp(A[x-1] + B[x+wsz-1] - logZ), each read 0 outside [0, N]
      const T a = x >= 1 ? p.A[(x - 1) * B + b] : T(0);
      const T bo = x + wsz - 1 <= N ? p.Bo[(x + wsz - 1) * B + b] : T(0);
      ext[i] = ex(a + bo - lz);
      // multiloop: b_multi[c][tt] multi[c][tt-wsz] at c = x + tt - 1, then
      // b_multi2[x+wsz-1][tt+wsz] multi2[x-1][tt]
      T part = T(0);
      for (int tt = wsz; tt < band && x + tt - 1 <= N; ++tt) {
        const long long g = ((x + tt - 1) * B + b) * band;
        part = part + p.b_multi[g + tt] * p.multi[g + tt - wsz];
      }
      if (x >= 1 && x + wsz - 1 <= N) {
        const long long g2 = ((x + wsz - 1) * B + b) * band,
                        g1 = ((x - 1) * B + b) * band;
        for (int tt = 0; tt <= W - wsz; ++tt)
          part = part + p.b_multi2[g2 + tt + wsz] * p.multi2[g1 + tt];
      }
      mp[i] = part * p.sigf[i];
    }
    // hairpin: SS[o][x+o-1] for o = w .. band-2 (w + 1 .. for p_w1)
    T hb = T(0), hc = T(0);
    for (int o = w; o <= band - 2 && x + o - 1 <= N; ++o) {
      const T t = *slot(p, o - w, x + o - 1, b);
      hb = hb + t;
      if (o > w) hc = hc + t;
    }
    // boundaries: srcL[u] at x - (u + 1 - w), sum_u srcR[u] at x + w - 1
    T bnd = T(0);
    for (int v = 0; v < p.nu && x - (v + 1) >= 0; ++v)
      bnd = bnd + *slot(p, p.nss + v, x - (v + 1), b);
    if (x + w - 1 <= N) bnd = bnd + *slot(p, p.nss + p.nu + 2 * p.nt,
                                          x + w - 1, b);
    // conditional windows: RL[t] at x - t (t descending), RR[tau] at
    // x + tau - 1 (tau descending)
    T bc = T(0);
    for (int t = p.nt; t >= 1; --t)
      if (x - t >= 0) bc = bc + *slot(p, p.nss + p.nu + t - 1, x - t, b);
    for (int v = p.nt - 1; v >= 0; --v) {
      const long long c = x + w + v;  // tau - 1 with tau = w + 1 + v
      if (c <= N) bc = bc + *slot(p, p.nss + p.nu + p.nt + v, c, b);
    }
    // linear branch where |logZ| <= 690: the clamp, and no conditional
    // part where the boundary sum is 0; log branch: neither
    T bib = bnd + bc, bic = bc;
    if (lz >= T(-690) && lz <= T(690)) {
      const T clamp = ex(p.c128 - lz);
      bib = bnd > T(0) ? smaller(bnd + bc, clamp) : T(0);
      bic = smaller(bc, clamp);
    }
    pw = ext[0] + hb + bib + mp[0];
    pw1 = ext[1] + hc + bic + mp[1];
  }
  p.p_w[x * B + b] = pw;
  p.p_w1[x * B + b] = pw1;
}

// C. epilogue_kernel: the window energies from p_w and p_w1, as
// accessibility/batched.py:accessibility_from_probabilities computes them
// (the JAX package's priblast_tpu/accessibility/batched.py:1370-1390, the
// end of _run_batch_impl): a thread per output element (b, j), j fastest,
// so that the writes of a row coalesce. For the window start x = j + 1:
// acc[b][j] = -kT log p_w[x] / 1000 where x + w - 1 <= n_b, else 0; the
// conditional -kT log p_w1[x] / 1000 - acc where x + w <= n_b, else 0,
// goes to cond[b][j + w] (the plain version's column shift, without a
// copy), and cond[b][j] = 0 for j < w. Each log is logf of
// (float)max(p, FLT_MIN), the libdevice function that torch.log calls on
// the card for float32; the products in float32 as the plain version
// orders them. Its division by 1000 is, on the card, PyTorch's division
// of a tensor by a host scalar: a product with the scalar's float32
// reciprocal (chip_smoke.py [kernel] checks that the two agree on the card,
// and counts the values where an IEEE division differs), so the kernel
// multiplies by the same reciprocal and matches the plain version bit for
// bit there; on the CPU, where PyTorch divides, within an ulp. Bound:
// bytes (two reads and two writes per element).
constexpr float kInv1000 = 1.0f / 1000.0f;  // rounded as PyTorch rounds it

template <typename T>
struct EpilogueParams {
  const T *p_w, *p_w1;     // [N+2][B]
  const int64_t *lengths;  // [B]
  float *acc, *cond;       // [B][N] each
  long long B, N;
  int w;
  float kT;
};

// torch.log(torch.clamp(p, min=FLT_MIN).to(float32)); a NaN stays NaN
template <typename T>
__device__ __forceinline__ float log_clamped(T p) {
  const T tiny = T(FLT_MIN);
  return logf((float)(p < tiny ? tiny : p));
}

template <typename T>
__global__ void __launch_bounds__(kEpilogueThreads)
    epilogue_kernel(EpilogueParams<T> p) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.B * p.N) return;
  const long long b = e / p.N, j = e - b * p.N, x = j + 1;
  const long long n = p.lengths[b];
  float a = 0.0f, c = 0.0f;
  if (x + p.w - 1 <= n)
    a = (-log_clamped(p.p_w[x * p.B + b]) * p.kT) * kInv1000;
  if (x + p.w <= n)
    c = (-log_clamped(p.p_w1[x * p.B + b]) * p.kT) * kInv1000 - a;
  const long long row = b * p.N;
  p.acc[row + j] = a;
  if (j + p.w < p.N) p.cond[row + j + p.w] = c;
  if (j < p.w) p.cond[row + j] = 0.0f;
}

// one launch of `kern`; the only launch site of this file
template <typename P>
int run(void (*kern)(P), long long grid, int threads, size_t bytes,
        void *stream, const P &p) {
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<(int)grid, threads, bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// ptrs: stem, stem_m, stem_a, multi, multi2, bse, bse_m, bse_a, b_multi,
//   b_multi2, hpW, A, B, logZ, codes (int64), KI, Kb, bp, rtbp (int32),
//   stack, int11, int21, int22 (float32), scratch, p_w, p_w1 (27 device
//   pointers);
// sizes: N+1, B, band, ML, w, S (codes per row), columns per CTA of the
//   window kernel, its threads per block (a multiple of 32), 1 to stage the
//   stem rows in shared memory where they fit;
// scalars: sigma^-1 .. sigma^-4, sigma^-w, sigma^-(w+1), 128 ln 2 (each
//   rounded to T), the bulge weight b1 (a float32 value)
template <typename T>
int launch(void *const *ptrs, const long long *sizes, const double *scalars,
           void *stream) {
  Params<T> p;
  const T **planes[] = {&p.stem, &p.stem_m, &p.stem_a, &p.multi, &p.multi2,
                        &p.bse, &p.bse_m, &p.bse_a, &p.b_multi, &p.b_multi2,
                        &p.hpW, &p.A, &p.Bo, &p.logZ};
  for (int i = 0; i < 14; ++i) *planes[i] = (const T *)ptrs[i];
  p.codes = (const int64_t *)ptrs[14];
  p.KI = (const T *)ptrs[15];
  p.Kb = (const T *)ptrs[16];
  p.bp = (const int *)ptrs[17];
  p.rtbp = (const int *)ptrs[18];
  p.stack = (const float *)ptrs[19];
  p.i11 = (const float *)ptrs[20];
  p.i21 = (const float *)ptrs[21];
  p.i22 = (const float *)ptrs[22];
  p.scr = (T *)ptrs[23];
  p.p_w = (T *)ptrs[24];
  p.p_w1 = (T *)ptrs[25];
  p.n1 = sizes[0];
  p.B = sizes[1];
  p.band = (int)sizes[2];
  const int ml = (int)sizes[3];
  p.w = (int)sizes[4];
  p.S = sizes[5];
  p.tile = (int)sizes[6];
  const int threads = (int)sizes[7];
  const bool want_staged = sizes[8] != 0;
  p.sig[0] = T(1);
  for (int k = 1; k <= 4; ++k) p.sig[k] = (T)scalars[k - 1];
  p.sigf[0] = (T)scalars[4];
  p.sigf[1] = (T)scalars[5];
  p.c128 = (T)scalars[6];
  p.b1 = (float)scalars[7];
  if (p.B == 0 || p.n1 == 0) return 0;
  if (ml != kML || p.w < 1 || p.band < 3 || p.tile < 1 || threads < 32 ||
      threads > kWindowMaxThreads || threads % 32 != 0 || p.S < 1)
    return (int)cudaErrorInvalidConfiguration;
  p.nss = p.band - 1 - p.w > 0 ? p.band - 1 - p.w : 0;
  p.nu = kML - p.w + 1 > 0 ? kML - p.w + 1 : 0;
  p.nt = p.nu > 0 ? p.nu - 1 : 0;
  // 8 mod 32: the lanes of a step hit distinct banks (block_spans)
  p.S2 = p.band + ((8 - p.band) % 32 + 32) % 32;

  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t base = (size_t)(tables_size() + threads / 32 *
                               warp_size(p.S2)) * sizeof(T);
  const size_t staged = base + (size_t)2 * staged_rows(p.tile, p.band) *
                                   p.S2 * sizeof(T);
  if (base > (size_t)max_smem) return (int)cudaErrorInvalidConfiguration;
  const long long grid = ceil_div(p.n1, p.tile) * p.B;
  const bool in_smem = want_staged && staged <= (size_t)max_smem;
  // from device memory, a diagonal's offsets k (B band + 1) are ints
  if (!in_smem && (p.B * p.band + 1) * p.band > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  int err = in_smem
                ? run(window_kernel<T, true>, grid, threads, staged, stream, p)
                : run(window_kernel<T, false>, grid, threads, base, stream,
                      p);
  if (err != 0) return err;
  return run(sum_kernel<T>, ceil_div((p.n1 + 1) * p.B, kSumThreads),
             kSumThreads, 0, stream, p);
}

// ptrs: p_w, p_w1 (T, [N+2][B]), lengths (int64, [B]), acc, cond (float32,
//   [B][N] each) (5 device pointers);
// sizes: B, N, w;
// scalars: kT (a float32 value).
template <typename T>
int epilogue(void *const *ptrs, const long long *sizes, const double *scalars,
             void *stream) {
  EpilogueParams<T> p;
  p.p_w = (const T *)ptrs[0];
  p.p_w1 = (const T *)ptrs[1];
  p.lengths = (const int64_t *)ptrs[2];
  p.acc = (float *)ptrs[3];
  p.cond = (float *)ptrs[4];
  p.B = sizes[0];
  p.N = sizes[1];
  p.w = (int)sizes[2];
  p.kT = (float)scalars[0];
  if (p.B == 0 || p.N == 0) return 0;
  if (p.B < 0 || p.N < 0 || sizes[2] < 1) return (int)cudaErrorInvalidValue;
  return run(epilogue_kernel<T>, ceil_div(p.B * p.N, kEpilogueThreads),
             kEpilogueThreads, 0, stream, p);
}

}  // namespace

#ifdef ACCESS_STAMPS
// The part names, comma-separated, in the order of the sums.
extern "C" const char *access_prob_stage_names() {
  return "staging,load,interior,bulge,reduce,tail";
}

// Copy the 2 * stages + 1 sums (cycles per part, kStages zeros, columns)
// to `out` and clear them; synchronises the device.
extern "C" int access_prob_stamps(unsigned long long *out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[2 * kStages + 1] = {};
  return (int)cudaMemcpyToSymbol(g_stamps, zero, sizeof(g_stamps));
}
#endif

extern "C" int access_prob_f32(void *const *ptrs, const long long *sizes,
                               const double *scalars, void *stream) {
  return launch<float>(ptrs, sizes, scalars, stream);
}

extern "C" int access_prob_f64(void *const *ptrs, const long long *sizes,
                               const double *scalars, void *stream) {
  return launch<double>(ptrs, sizes, scalars, stream);
}

extern "C" int access_epilogue_f32(void *const *ptrs, const long long *sizes,
                                   const double *scalars, void *stream) {
  return epilogue<float>(ptrs, sizes, scalars, stream);
}

extern "C" int access_epilogue_f64(void *const *ptrs, const long long *sizes,
                                   const double *scalars, void *stream) {
  return epilogue<double>(ptrs, sizes, scalars, stream);
}
