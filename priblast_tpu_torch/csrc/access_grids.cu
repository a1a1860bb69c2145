// The accessibility DP's weight grids for Hopper (sm_90a): from the padded
// codes of a batch, every weight plane that the inside and outside column
// scans read, in two launches behind two C entry points per dtype.
//
// Replaces the XLA programs of the JAX package that build these planes:
// priblast_tpu/accessibility/batched.py:make_grids (:372) and
// make_outside_grids (:741), in their plain gather form (`_packed_take`),
// not the one-hot bilinear form. The planes follow the plain PyTorch
// versions, priblast_tpu_torch/accessibility/batched.py:make_grids and
// make_outside_grids, value for value: each table value is read as the
// float32 it is there, every product is taken in the same type and order
// (build with -fmad=false, so that no product is fused into an add), and
// only the seed's exp may round otherwise than PyTorch's.
//
// Layout: every plane is [N+1][B][band] (column j leading, span d last),
// contiguous; the bool planes one byte per cell; A and B [N+1][B], logZ
// [B], the codes [B][S] (1-based, zero padded; a read outside [0, S) is
// code 0), the lengths [B] int64.
//
// Bound on this card: the planes' bytes (15 float planes and 2 bool
// planes inside, 14 and 2 outside plus a read of multi2), a few dozen
// operations per cell (chip_smoke.py grids_bound_ms).
//
// The inside launch runs a thread per cell (j, b, d), span fastest, in a
// grid-stride loop: a warp's 32 cells of one column read consecutive
// codes, which the caches serve, and write consecutive spans; it runs at
// ~1.13x its byte bound (a CTA per row and tile with the codes staged in
// shared memory ran slower on the card, 1.20-1.54x: access_ab.py --kernel
// grids).
//
// The outside launch cannot: there a cell (q, b, d) reads A[q - d],
// multi2[q + d][d] and its codes at addresses that move with d, so a
// thread per cell gathers A at a stride of B values and multi2 at a
// stride of B band + 1 across a warp, a 32-byte sector for each 4-byte
// value (1.57x its bound). So it runs a CTA per (row b, tile of `tile`
// columns), which first stages what its cells read into shared memory,
// coalesced: the row's codes as bytes over [q0 - band - 1, q0 + tile +
// 3), 0 outside [0, S); the row's strip of A over [q0 - band + 1, q0 +
// tile) and of B over the tile; and the parallelogram of multi2 that the
// tile's cells read (rows r in [q0, q0 + tile + band - 1), the spans d
// with r - d in the tile), each row's spans a contiguous segment, copied
// with cp.async. Then its threads take the tile's cells, span fastest,
// read those from shared memory and the float32 Turner tables through
// the read-only cache (__ldg), and write every plane, so a warp's writes
// are a column's consecutive spans. Cell offsets within a CTA are 32-bit.
//
// C entry points (ctypes): access_grids_inside_{f32,f64} and
// access_grids_outside_{f32,f64}. They take (ptrs, sizes, scalars,
// stream), launch on the given stream and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kTile = 16;  // columns per CTA where the caller gives 0
constexpr int kInsideF = 15, kOutsideF = 14;  // float planes per launch

// The float32 Turner tables of the plain versions (batched.py:_F32Tables),
// bp and rtype[bp] as int32, and two per-span rows of the band
struct Tabs {
  const int *bp, *rtbp;          // 5 x 5
  const float *stack;            // 7 x 7
  const float *mi, *mh;          // mismatch interior / hairpin, 7 x 5 x 5
  const float *i11, *i21, *i22;  // 8 x 8 x 5^2, 5^3, 5^4
  const float *d5, *d3;          // dangles, 7 x 5
  const float *au;               // 7
  const float *hl;               // band: float32(hairpin length weight *
                                 // sigma^-d)
  const float *sigp;             // band: float32(sigma^d)
};

template <typename T>
struct Params {
  Tabs tb;
  const int64_t *codes, *len;
  const T *A, *Bo, *logZ, *multi2;  // outside only
  T *f[kInsideF];                   // the float planes, in field order
  bool *m[2];                       // the bool planes
  long long n1, B, S, cells;
  int band, tile;  // tile: the outside launch's columns per CTA
  T sig[5];        // sigma^-k, k = 0..4, each rounded to T
  float b1;        // bulge-length weight of one unpaired base
  float mlcw;      // float32(W_mlc * W_mli)
  float lsig;      // float32(log sigma)
};

// The outside launch's shared memory per CTA, in bytes from its start:
// multi2's parallelogram by cell [tile][band] (at 0), B over the tile and
// A over [q0 - band + 1, q0 + tile), all in T; then the codes over [q0 -
// band - 1, q0 + tile + 3) as bytes
struct Stage {
  int bq, a, codes, bytes;
};

__host__ __device__ inline Stage stage_layout(int tile, int band,
                                              int item) {
  Stage s;
  s.bq = tile * band * item;
  s.a = s.bq + tile * item;
  s.codes = s.a + (tile + band - 1) * item;
  s.bytes = (s.codes + tile + band + 4 + 15) / 16 * 16;
  return s;
}

// one value from device to shared memory with cp.async (4 or 8 bytes),
// waited for by copy_wait; a plain copy where no card compiles it
template <typename T>
__device__ __forceinline__ void copy_async(T *dst, const T *src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T)));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
#endif
}

template <typename T>
__device__ __forceinline__ int code_at(const Params<T> &p, long long b,
                                       long long pos) {
  return pos >= 0 && pos < p.S ? (int)p.codes[b * p.S + pos] : 0;
}

__device__ __forceinline__ float ex(float v) { return expf(v); }
__device__ __forceinline__ double ex(double v) { return exp(v); }

__device__ __forceinline__ int ld(const int *t, int k) { return __ldg(t + k); }
__device__ __forceinline__ float ld(const float *t, int k) {
  return __ldg(t + k);
}

// batched.py:make_grids for the cell (j, b, d): the pair (i+1, j) of type
// T1 inside the closing pair (i, j+1) of type TC, i = j - d
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    inside_kernel(const Params<T> p) {
  const Tabs &tb = p.tb;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < p.cells; idx += stride) {
    const int d = (int)(idx % p.band);
    const long long jb = idx / p.band, b = jb % p.B, j = jb / p.B;
    const long long i = j - d, n = p.len[b];
    const int si = code_at(p, b, i), si1 = code_at(p, b, i + 1),
              si2 = code_at(p, b, i + 2), si3 = code_at(p, b, i + 3);
    const int sj = code_at(p, b, j), sjm1 = code_at(p, b, j - 1),
              sjm2 = code_at(p, b, j - 2), sjp1 = code_at(p, b, j + 1);
    const int T1 = ld(tb.bp, si1 * 5 + sj), T1r = ld(tb.rtbp, si1 * 5 + sj);
    const int T2r = ld(tb.rtbp, si2 * 5 + sjm1);
    const int TC = ld(tb.bp, si * 5 + sjp1), TCr = ld(tb.rtbp, si * 5 + sjp1);

    // the dangle of pair (i+1, j) on (i, j), in float32
    const float w5 = i > 0 ? ld(tb.d5, T1 * 5 + si) : 1.0f;
    const float w3 = j < n ? ld(tb.d3, T1 * 5 + sjp1) : 1.0f;
    const float wau = j == n && T1 > 2 ? ld(tb.au, T1) : 1.0f;
    const T dangle = T(T1 != 0 ? w5 * w3 * wau : 1.0f);
    // the hairpin closed by (i, j+1): its terminal mismatch, or at d = 3
    // its AU penalty, times the float32 length weight
    const float hp = d == 3 ? (TC > 2 ? ld(tb.au, TC) : 1.0f)
                            : ld(tb.mh, (TC * 5 + si1) * 5 + sj);
    const int X10 = ld(tb.rtbp, si2 * 5 + sj), X01 = ld(tb.rtbp, si1 * 5 + sjm1);
    const int t12r = ld(tb.rtbp, si2 * 5 + sjm2),
              t21r = ld(tb.rtbp, si3 * 5 + sjm1),
              t22r = ld(tb.rtbp, si3 * 5 + sjm2);

    T *const *f = p.f;
    f[0][idx] = T(ld(tb.stack, T1 * 7 + T2r));                   // stackW
    f[1][idx] = T(ld(tb.mi, (T1r * 5 + sjp1) * 5 + si));          // mism_in
    f[2][idx] = T(ld(tb.au, T1r));                                // au_in
    f[3][idx] = dangle;                                           // dangle_ij
    f[4][idx] = T(hp * ld(tb.hl, d));                             // hpW
    f[5][idx] = T(ld(tb.mi, (TC * 5 + si1) * 5 + sj));            // mism_out
    f[6][idx] = T(ld(tb.au, TC));                                 // au_out
    f[7][idx] = T(p.mlcw * ld(tb.d3, TCr * 5 + si1) *
                  ld(tb.d5, TCr * 5 + sj));                       // mlclose
    f[8][idx] = T(p.b1 * ld(tb.stack, TC * 7 + X10)) * p.sig[1];  // sp10
    f[9][idx] = T(p.b1 * ld(tb.stack, TC * 7 + X01)) * p.sig[1];  // sp01
    f[10][idx] = T(ld(tb.i11, ((TC * 8 + T2r) * 5 + si1) * 5 + sj)) *
                 p.sig[2];                                        // sp11
    f[11][idx] =
        T(ld(tb.i21, (((TC * 8 + t12r) * 5 + si1) * 5 + sjm1) * 5 + sj)) *
        p.sig[3];                                                 // sp12
    f[12][idx] =
        T(ld(tb.i21, (((t21r * 8 + TC) * 5 + sj) * 5 + si1) * 5 + si2)) *
        p.sig[3];                                                 // sp21
    f[13][idx] = T(ld(tb.i22, ((((TC * 8 + t22r) * 5 + si1) * 5 + si2) * 5 +
                               sjm1) * 5 + sj)) *
                 p.sig[4];                                        // sp22
    f[14][idx] = T(ld(tb.sigp, d)) * dangle;                      // ext_dot
    p.m[0][idx] = T1 != 0;                                        // t1_nz
    p.m[1][idx] = TC != 0 && j != n;                              // validC
  }
}

// batched.py:make_outside_grids for the cells (q, b, d) of a tile: the
// pair (p+1, q) of type T2 inside the closing pair (p, q+1) of type TC,
// p = q - d; dangle_pq is the inside launch's dangle_ij and is not written
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    outside_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tabs &tb = p.tb;
  const int Q = p.tile, band = p.band;
  const Stage L = stage_layout(Q, band, sizeof(T));
  T *m2s = reinterpret_cast<T *>(smem);
  T *bqs = reinterpret_cast<T *>(smem + L.bq);
  T *as = reinterpret_cast<T *>(smem + L.a);
  unsigned char *cs = smem + L.codes;
  const int b = (int)(blockIdx.x % p.B), q0 = (int)(blockIdx.x / p.B) * Q;
  const int n1 = (int)p.n1;

  // A over [q0 - band + 1, q0 + Q) and B over the tile, 0 past the ends
  for (int k = threadIdx.x; k < Q + band - 1; k += blockDim.x) {
    const int pos = q0 - band + 1 + k;
    if (pos >= 0 && pos < n1)
      copy_async(as + k, p.A + (long long)pos * p.B + b);
    else
      as[k] = T(0);
  }
  for (int k = threadIdx.x; k < Q; k += blockDim.x) {
    if (q0 + k < n1)
      copy_async(bqs + k, p.Bo + (long long)(q0 + k) * p.B + b);
    else
      bqs[k] = T(0);
  }
  // multi2[r][b][d] into the cell (r - d, d), row by row: row r = q0 + rl
  // holds the spans d in [rl - Q + 1, rl] of the band, a warp's lanes on
  // consecutive spans; 0 past the last column
  for (int k = threadIdx.x; k < (Q + band - 1) * Q; k += blockDim.x) {
    const int rl = k / Q, d = max(0, rl - Q + 1) + (k - rl * Q);
    if (d > rl || d >= band) continue;
    T *dst = m2s + (rl - d) * band + d;
    if (q0 + rl < n1)
      copy_async(dst, p.multi2 + ((long long)(q0 + rl) * p.B + b) * band + d);
    else
      *dst = T(0);
  }
  // the codes over [q0 - band - 1, q0 + Q + 3) as bytes, 0 outside [0, S)
  for (int k = threadIdx.x; k < Q + band + 4; k += blockDim.x)
    cs[k] = (unsigned char)code_at(p, b, (long long)q0 - band - 1 + k);
  const int n = (int)p.len[b];
  const T logZ = p.logZ[b];
  copy_wait();
  __syncthreads();

  // the cell (q0 + ql, b, d) lies at base + ql B band + d of every plane
  const long long base = ((long long)q0 * p.B + b) * band;
  const int col = (int)p.B * band;
  const int cells = min(Q, n1 - q0) * band;  // the last tile may be short
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const int ql = c / band, d = c - ql * band;
    const int q = q0 + ql, pp = q - d;
    // the codes at p and at q
    const unsigned char *cp = cs + (ql - d + band + 1), *cq = cs + ql + band
                                                              + 1;
    const int s_p = cp[0], s_p1 = cp[1], s_pm1 = cp[-1];
    const int s_q = cq[0], s_q1 = cq[1], s_q2 = cq[2];
    const int T2 = ld(tb.bp, s_p1 * 5 + s_q), T2r = ld(tb.rtbp, s_p1 * 5 + s_q);
    const int TC = ld(tb.bp, s_p * 5 + s_q1), TCr = ld(tb.rtbp, s_p * 5 + s_q1);
    // closing types of the displaced bse cells (p - v1, q + v2)
    auto ct = [&](int v1, int v2) {
      return ld(tb.bp, cp[-v1] * 5 + cq[v2 + 1]);
    };
    const int tc10 = ct(1, 0), tc01 = ct(0, 1), tc11 = ct(1, 1),
              tc12 = ct(1, 2), tc21 = ct(2, 1), tc22 = ct(2, 2);

    // seed: exp(A[p] + B[q] - logZ + d lsig), A read at float32 and d lsig
    // taken in float32, the sum in T left to right; 0 where p < 0
    T seed = T(0);
    if (pp >= 0) {
      const float a = (float)as[ql - d + band - 1];
      const float dl = (float)d * p.lsig;
      seed = ex(((T(a) + bqs[ql]) - logZ) + T(dl));
    }

    const long long idx = base + (ql * col + d);
    T *const *f = p.f;
    f[0][idx] = seed;
    f[1][idx] = T(TC != 0 ? ld(tb.mi, (TC * 5 + s_p1) * 5 + s_q)
                          : 0.0f);                            // bse_mism_w
    f[2][idx] = T(TC != 0 ? ld(tb.au, TC) : 0.0f);            // bse_au_w
    f[3][idx] = T(ld(tb.mi, (T2r * 5 + s_q1) * 5 + s_p));     // mism_out2
    f[4][idx] = T(ld(tb.au, T2r));                            // au_out2
    f[5][idx] = TC != 0 && pp != 0 && q != n
                    ? T(ld(tb.stack, TC * 7 + T2r)) * p.sig[2]
                    : T(0);                                   // contW
    f[6][idx] = T(p.mlcw * ld(tb.d3, TCr * 5 + s_p1) *
                  ld(tb.d5, TCr * 5 + s_q));                  // mlclose_o
    f[7][idx] = T(p.b1 * ld(tb.stack, tc10 * 7 + T2r)) * p.sig[1];  // spo10
    f[8][idx] = T(p.b1 * ld(tb.stack, tc01 * 7 + T2r)) * p.sig[1];  // spo01
    f[9][idx] = tc11 != 0 ? T(ld(tb.i11, ((tc11 * 8 + T2r) * 5 + s_p) * 5 +
                                 s_q1)) * p.sig[2]
                          : T(0);                             // spo11
    f[10][idx] = tc12 != 0
                     ? T(ld(tb.i21, (((tc12 * 8 + T2r) * 5 + s_p) * 5 + s_q1) *
                                        5 + s_q2)) * p.sig[3]
                     : T(0);                                  // spo12
    f[11][idx] = tc21 != 0
                     ? T(ld(tb.i21, (((T2r * 8 + tc21) * 5 + s_q1) * 5 +
                                     s_pm1) * 5 + s_p)) * p.sig[3]
                     : T(0);                                  // spo21
    f[12][idx] = tc22 != 0
                     ? T(ld(tb.i22, ((((tc22 * 8 + T2r) * 5 + s_pm1) * 5 +
                                      s_p) * 5 + s_q1) * 5 + s_q2)) * p.sig[4]
                     : T(0);                                  // spo22
    // multi2[q + d][d], the last span times 0
    f[13][idx] = m2s[c] * (d == band - 1 ? T(0) : T(1));      // m2diag
    p.m[0][idx] = T2 != 0;                                    // t2_nz
    p.m[1][idx] = pp > 0 && q != n;                           // valid_int
  }
}

// one launch of `kern`; the only launch site of this file
template <typename P>
int run(void (*kern)(P), long long grid, int threads, int bytes,
        void *stream, const P &p) {
  if (bytes > 48 * 1024) {
    int dev = 0, max_smem = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    if (bytes > max_smem) return (int)cudaErrorInvalidConfiguration;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
  }
  kern<<<(int)grid, threads, bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// ptrs: codes (int64), lengths (int64), bp, rtbp (int32), stack, mi, mh,
//   i11, i21, i22, d5, d3, au, hl, sigp (float32); outside: A, B, logZ,
//   multi2; then the float planes in field order and the two bool planes;
// sizes: N+1, B, band, S (codes per row), threads per CTA; the inside
//   launch's CTAs (0: a thread per cell; fewer stride over the cells);
//   the outside launch's columns per CTA (0: kTile);
// scalars: sigma^-1 .. sigma^-4 (each rounded to T), b1, float32(W_mlc
//   W_mli), log sigma (each a float32 value)
template <typename T>
int launch(bool outside, void *const *ptrs, const long long *sizes,
           const double *scalars, void *stream) {
  Params<T> p = {};
  int k = 0;
  p.codes = (const int64_t *)ptrs[k++];
  p.len = (const int64_t *)ptrs[k++];
  p.tb.bp = (const int *)ptrs[k++];
  p.tb.rtbp = (const int *)ptrs[k++];
  const float **tabs[] = {&p.tb.stack, &p.tb.mi, &p.tb.mh, &p.tb.i11,
                          &p.tb.i21, &p.tb.i22, &p.tb.d5, &p.tb.d3,
                          &p.tb.au, &p.tb.hl, &p.tb.sigp};
  for (const float **t : tabs) *t = (const float *)ptrs[k++];
  if (outside) {
    p.A = (const T *)ptrs[k++];
    p.Bo = (const T *)ptrs[k++];
    p.logZ = (const T *)ptrs[k++];
    p.multi2 = (const T *)ptrs[k++];
  }
  const int nf = outside ? kOutsideF : kInsideF;
  for (int i = 0; i < nf; ++i) p.f[i] = (T *)ptrs[k++];
  for (int i = 0; i < 2; ++i) p.m[i] = (bool *)ptrs[k++];
  p.n1 = sizes[0];
  p.B = sizes[1];
  p.S = sizes[3];
  const int threads = (int)sizes[4];
  const long long blocks = sizes[5];
  if (p.n1 < 0 || p.B < 0 || sizes[2] < 1 || sizes[2] > 4096 || p.S < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      blocks < 0 || sizes[6] < 0 || sizes[6] > 4096)
    return (int)cudaErrorInvalidConfiguration;
  p.band = (int)sizes[2];
  p.tile = sizes[6] > 0 ? (int)sizes[6] : kTile;
  p.sig[0] = T(1);
  for (int i = 1; i <= 4; ++i) p.sig[i] = (T)scalars[i - 1];
  p.b1 = (float)scalars[4];
  p.mlcw = (float)scalars[5];
  p.lsig = (float)scalars[6];
  p.cells = p.n1 * p.B * p.band;
  if (p.cells == 0) return 0;
  if (!outside) {
    long long grid = blocks > 0 ? blocks : (p.cells + threads - 1) / threads;
    if (grid > 0x7fffffff) grid = 0x7fffffff;  // the loop strides the rest
    return run(inside_kernel<T>, grid, threads, 0, stream, p);
  }
  // a CTA per row and tile; 32-bit columns, rows and offsets in a tile
  const long long grid = (p.n1 + p.tile - 1) / p.tile * p.B;
  if (grid > 0x7fffffff || p.n1 + p.tile > 0x7fffffff ||
      (long long)p.tile * p.B * p.band > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  const int bytes = stage_layout(p.tile, p.band, sizeof(T)).bytes;
  return run(outside_kernel<T>, grid, threads, bytes, stream, p);
}

}  // namespace

extern "C" int access_grids_inside_f32(void *const *ptrs,
                                       const long long *sizes,
                                       const double *scalars, void *stream) {
  return launch<float>(false, ptrs, sizes, scalars, stream);
}

extern "C" int access_grids_inside_f64(void *const *ptrs,
                                       const long long *sizes,
                                       const double *scalars, void *stream) {
  return launch<double>(false, ptrs, sizes, scalars, stream);
}

extern "C" int access_grids_outside_f32(void *const *ptrs,
                                        const long long *sizes,
                                        const double *scalars, void *stream) {
  return launch<float>(true, ptrs, sizes, scalars, stream);
}

extern "C" int access_grids_outside_f64(void *const *ptrs,
                                        const long long *sizes,
                                        const double *scalars, void *stream) {
  return launch<double>(true, ptrs, sizes, scalars, stream);
}
