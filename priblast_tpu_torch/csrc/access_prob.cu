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
// nonnegative weight). Build with -fmad=false, as the other kernels.
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
// of them the interior loops' two contractions (phase A below), against
// eleven planes read once: the operations bound it (chip_smoke.py
// prob_ops_per_column). The design is the first, simple one:
//   A. window_kernel: a CTA per (row b, tile of columns), a warp per
//      column c, lane l for loop size u = w + l (u <= ML), so that each
//      lane sums its own terms with no reduction between lanes:
//      - srcR[u][c] = sum_e bse_m[c][e] sum_u1 stem_m[c-u][e-u-u1]
//        K[u1][u] + Kb[u] sum_e bse_a[c][e] stem_a[c-u][e-u] (+ the
//        small-loop specials where w <= 2): the loops whose right side
//        has u unpaired bases, indexed by the closing column;
//      - srcL[u][c] likewise for the left side, indexed by the left end
//        c of the closing pair (outer cell (c+e, e));
//      - the hairpin suffix sums SS[o][c] = sum_{e >= o} bse hpW, added in
//        float64 in descending e and rounded to the dtype, the plain
//        version's order and precision (lane per o);
//      - the running sums of srcL / srcR over u that the conditional
//        windows read, in the plain version's order;
//      into a scratch buffer [K][N+1][B]. The stem_m and stem_a rows that a
//      tile reads (its columns, ML before, band after) are staged in
//      shared memory, row stride even, so that lanes reading down a
//      diagonal hit distinct banks; the K tables in both orientations.
//   B. sum_kernel: a thread per (window x, row b): the exterior term, the
//      hairpin and multiloop gathers at shifted columns, the boundary and
//      conditional sums of srcL / srcR, the linear / log branch (the clamp
//      at e^(128 ln 2 - logZ) and the conditional part dropped where the
//      boundary sum is 0, only where |logZ| <= 690), then p_w and p_w1.
// The small-loop weights (w <= 2 only) are computed from the characters
// and the int11 / int21 / int22 / stack tables (read through L1), so the
// kernel never reads a weight grid.
//
// C entry points (ctypes): access_prob_f32, access_prob_f64. They launch
// on the given stream and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kML = 30;          // thermo.MAXLOOP, the tables' size
constexpr int kKS = 32;          // row stride of the K tables in shared memory
constexpr int kMaxThreads = 1024;
constexpr int kSumThreads = 256;  // threads per block of sum_kernel

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

// shared memory, in elements of T: the K tables (KR[u1][u2] and KL[u2][u1],
// rows of kKS), Kb, per warp five band-long rows (bse_m and bse_a of the
// column and of its diagonal, bse hpW) and the 64 sums of the column, then
// the staged stem_m and stem_a rows
__host__ __device__ inline int tables_size() { return 2 * (kML + 1) * kKS + kKS; }
__host__ __device__ inline int warp_size(int band) { return 5 * band + 64; }
__host__ __device__ inline int staged_rows(int tile, int band) {
  return tile + band - 1 + kML;
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
    window_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T *sm = reinterpret_cast<T *>(smem);
  const int band = p.band, w = p.w, lane = threadIdx.x & 31,
            warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const long long B = p.B, N = p.n1 - 1;
  const long long b = blockIdx.x % B;
  const long long c0 = (long long)(blockIdx.x / B) * p.tile;
  const long long c1 = c0 + p.tile < p.n1 ? c0 + p.tile : p.n1;
  const long long r0 = c0 - kML;  // first staged row
  const int S2 = p.S2;

  T *KR = sm, *KL = KR + (kML + 1) * kKS, *Kbs = KL + (kML + 1) * kKS;
  T *wb = Kbs + kKS + warp * warp_size(band);
  T *bmr = wb, *bml = wb + band, *bar = wb + 2 * band, *bal = wb + 3 * band,
    *hp = wb + 4 * band, *tot = wb + 5 * band;
  T *stm = sm + tables_size() + nwarps * warp_size(band);
  T *sta = stm + (long long)staged_rows(p.tile, band) * S2;

  for (int i = threadIdx.x; i < (kML + 1) * kKS; i += blockDim.x) {
    const int a = i / kKS, c = i % kKS;
    KR[i] = c <= kML ? p.KI[a * (kML + 1) + c] : T(0);
    KL[i] = c <= kML ? p.KI[c * (kML + 1) + a] : T(0);
  }
  for (int i = threadIdx.x; i < kKS; i += blockDim.x)
    Kbs[i] = i <= kML ? p.Kb[i] : T(0);
  if (kStaged) {
    const int rows = staged_rows(p.tile, band);
    for (long long i = threadIdx.x; i < (long long)rows * band;
         i += blockDim.x) {
      const long long r = i / band, k = i % band, gr = r0 + r;
      const bool in = gr >= 0 && gr <= N;
      const long long g = (gr * B + b) * band + k;
      stm[r * S2 + k] = in ? p.stem_m[g] : T(0);
      sta[r * S2 + k] = in ? p.stem_a[g] : T(0);
    }
  }
  __syncthreads();

  // row `r` (a column of the planes) of stem_m / stem_a, for r0 <= r <=
  // N and r < c1 + band - 1
  auto sm_row = [&](long long r) -> const T * {
    return kStaged ? stm + (r - r0) * S2 : p.stem_m + (r * B + b) * band;
  };
  auto sa_row = [&](long long r) -> const T * {
    return kStaged ? sta + (r - r0) * S2 : p.stem_a + (r * B + b) * band;
  };
  const int u = w + lane;  // this lane's loop size
  const bool active = lane < p.nu;

  for (long long c = c0 + warp; c < c1; c += nwarps) {
    for (int e = lane; e < band; e += 32) {
      const long long g = (c * B + b) * band + e;
      bmr[e] = p.bse_m[g];
      bar[e] = p.bse_a[g];
      hp[e] = p.bse[g] * p.hpW[g];
      const bool in = c + e <= N;
      const long long gd = ((c + e) * B + b) * band + e;
      bml[e] = in ? p.bse_m[gd] : T(0);
      bal[e] = in ? p.bse_a[gd] : T(0);
    }
    __syncwarp();

    // hairpin suffix sums, o = w .. band - 2
    for (int o = w + lane; o <= band - 2; o += 32) {
      double run = 0.0;
      for (int e = band - 1; e >= o; --e) run = run + (double)hp[e];
      *slot(p, o - w, c, b) = (T)run;
    }

    T R = T(0), L = T(0);
    if (active) {
      if (c >= u) {  // the inner stem at column c - u
        const T *row = sm_row(c - u);
        T acc = T(0);
        for (int e = u + 1; e < band; ++e) {
          const int top = kML - u < e - u ? kML - u : e - u;
          T h = T(0);
          for (int u1 = 1; u1 <= top; ++u1)
            h = h + row[e - u - u1] * KR[u1 * kKS + u];
          acc = acc + bmr[e] * h;
        }
        R = acc;
        if (u >= 2) {
          const T *rowa = sa_row(c - u);
          T bs = T(0);
          for (int e = u; e < band; ++e) bs = bs + bar[e] * rowa[e - u];
          R = R + bs * Kbs[u];
        }
      }
      T acc = T(0);
      for (int e = u + 1; e < band && c + e <= N; ++e) {
        const int top = kML - u < e - u ? kML - u : e - u;
        T g = T(0);
        for (int u2 = 1; u2 <= top; ++u2)
          g = g + sm_row(c + e - u2)[e - u - u2] * KL[u2 * kKS + u];
        acc = acc + bml[e] * g;
      }
      L = acc;
      if (u >= 2) {
        T bs = T(0);
        for (int e = u; e < band && c + e <= N; ++e)
          bs = bs + bal[e] * sa_row(c + e)[e - u];
        L = L + bs * Kbs[u];
      }
      // the small-loop specials (w <= 2 only), in the plain version's
      // order, into srcR[u2] and srcL[u1]
      for (int k = 0; k < 6 && u <= 2; ++k) {
        const int u1 = kSpU1[k], u2 = kSpU2[k];
        if (u2 == u && c >= u2) {
          T sp = T(0);
          for (int e = u1 + u2; e < band; ++e) {
            const long long g = (c * B + b) * band + e;
            sp = sp + p.bse[g] * special_weight(p, k, c, e, b) *
                          p.stem[((c - u2) * B + b) * band + e - u1 - u2];
          }
          R = R + sp;
        }
        if (u1 == u) {
          T sp = T(0);
          for (int e = u1 + u2; e < band && c + e <= N; ++e) {
            const long long g = ((c + e) * B + b) * band + e;
            sp = sp + p.bse[g] * special_weight(p, k, c + e, e, b) *
                          p.stem[((c + e - u2) * B + b) * band + e - u1 - u2];
          }
          L = L + sp;
        }
      }
    }
    tot[lane] = R;
    tot[32 + lane] = L;
    __syncwarp();
    // srcL[u]; the running sums in descending u from ML; the sum of srcR
    // in ascending u
    if (active) *slot(p, p.nss + lane, c, b) = L;
    if (lane < p.nt) {
      T run = T(0);
      for (int v = kML; v >= lane + 1 + w; --v) run = run + tot[32 + v - w];
      *slot(p, p.nss + p.nu + lane, c, b) = run;
      run = T(0);
      for (int v = kML; v >= w + 1 + lane; --v) run = run + tot[v - w];
      *slot(p, p.nss + p.nu + p.nt + lane, c, b) = run;
    }
    if (lane == 0) {
      T run = T(0);
      for (int v = 0; v < p.nu; ++v) run = run + tot[v];
      *slot(p, p.nss + p.nu + 2 * p.nt, c, b) = run;
    }
    __syncwarp();
  }
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
      threads > kMaxThreads || threads % 32 != 0 || p.S < 1)
    return (int)cudaErrorInvalidConfiguration;
  p.nss = p.band - 1 - p.w > 0 ? p.band - 1 - p.w : 0;
  p.nu = kML - p.w + 1 > 0 ? kML - p.w + 1 : 0;
  p.nt = p.nu > 0 ? p.nu - 1 : 0;
  p.S2 = p.band + (p.band & 1);  // even: a diagonal's lanes hit distinct banks

  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t base = (size_t)(tables_size() + threads / 32 *
                               warp_size(p.band)) * sizeof(T);
  const size_t staged = base + (size_t)2 * staged_rows(p.tile, p.band) *
                                   p.S2 * sizeof(T);
  if (base > (size_t)max_smem) return (int)cudaErrorInvalidConfiguration;
  const long long grid = ceil_div(p.n1, p.tile) * p.B;
  int err = want_staged && staged <= (size_t)max_smem
                ? run(window_kernel<T, true>, grid, threads, staged, stream, p)
                : run(window_kernel<T, false>, grid, threads, base, stream,
                      p);
  if (err != 0) return err;
  return run(sum_kernel<T>, ceil_div((p.n1 + 1) * p.B, kSumThreads),
             kSumThreads, 0, stream, p);
}

}  // namespace

extern "C" int access_prob_f32(void *const *ptrs, const long long *sizes,
                               const double *scalars, void *stream) {
  return launch<float>(ptrs, sizes, scalars, stream);
}

extern "C" int access_prob_f64(void *const *ptrs, const long long *sizes,
                               const double *scalars, void *stream) {
  return launch<double>(ptrs, sizes, scalars, stream);
}
