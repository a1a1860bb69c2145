// The accessibility DP's outside column scan for Hopper (sm_90a): one CTA
// per sequence runs every column of its sequence, for descending q, in one
// launch, with the carry in shared memory.
//
// Replaces the XLA program of the JAX package that computes this scan: the
// column lax.scan of priblast_tpu/accessibility/batched.py:outside_pass
// (:926). Reference semantics: src/raccess.cpp:273-420. The terms follow
// the plain PyTorch version, priblast_tpu_torch/accessibility/batched.py:
// outside_pass, one for one; only the order in which a sum adds its terms
// differs (every term is a nonnegative weight). Build with -fmad=false, as
// the other kernels.
//
// Layout: every grid, multi1 and every output plane is [N+1][B][band]
// (column q leading, span d last), as the plain version's.
//
// Per column q = N..0 (three stages, each ended by a block barrier):
//   1. per span d: bse (from the next column's b_stem at span d+2, masked
//      to valid_int and d < W), bse_mism, bse_au and the multiloop closing
//      term clos;
//   2. all threads: the interior-loop contraction
//      Gp[r][e] = sum_u K2[r][u] * bse_mism[q+u][e] (u <= r), the multi
//      sum bmulti[d] = sum_{e>=d} clos[e] Lrow[e-d] (Lrow[k] =
//      (W_mlb sigma^-1)^k, the first column of the upper-triangular
//      LmatU), bm1[d] = sum_t bmb[q+t][d+t] multi2[q+t][t] and the two
//      bulge sums;
//   3. per span d: b_multi2 (bm1, the next column's b_multi2 at span d+1,
//      and the same-column sum over f of bmb[q][d+f] multi1[q-d][f], read
//      from the inside planes in device memory, which hit L2), gen[d] =
//      sum_r Gp[r][d+r], the small-loop specials, the helix continuation
//      and b_stem.
//
// Shared memory (the carry): the bse_mism and bse_au windows ((ML+1) x
// band each, a ring over columns), the b_multibif window ((W+1) x band),
// the last three bse columns, b_stem and b_multi2 (two buffers each), clos,
// bm1, bmulti, the bulge sums, Gp ((ML+1) x band) and the tables K2, Kb and
// Lrow: ~55 KB in float, ~109 KB in double at band 72.
//
// Bound on this card: the bytes of the grids, multi1 and the planes, each
// read or written once, set the least time; the operations it needs (most
// of them the K2 triangle, u <= r and e >= r) take less. The columns are a
// chain of dependent steps with three block barriers each, over B CTAs
// only, so the kernel is bound by the latency of one column step, far
// above either.
//
// C entry points (ctypes): access_outside_f32, access_outside_f64. They
// launch on the given stream and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// offsets (in elements of T) of the shared-memory regions
struct Layout {
  int k2, kb, lrow, bsew, bsaw, bmbw, bse, bst, bm2, clos, bm1, bmul, gp,
      bul, total;
};

__host__ __device__ inline Layout layout(int band, int ml) {
  const int R = ml + 1, W = band - 2;
  Layout l;
  int o = 0;
  l.k2 = o;   o += R * R;
  l.kb = o;   o += R;
  l.lrow = o; o += band;
  l.bsew = o; o += R * band;
  l.bsaw = o; o += R * band;
  l.bmbw = o; o += (W + 1) * band;
  l.bse = o;  o += 3 * band;
  l.bst = o;  o += 2 * band;
  l.bm2 = o;  o += 2 * band;
  l.clos = o; o += band;
  l.bm1 = o;  o += band;
  l.bmul = o; o += band;
  l.gp = o;   o += R * band;
  l.bul = o;  o += band;
  l.total = o;
  return l;
}

template <typename T>
struct Params {
  // grids (batched.py:OutsideGrids), [N+1][B][band]
  const T *seed, *dangle, *bse_mism_w, *bse_au_w, *mism_out2, *au_out2,
      *contW, *mlclose_o, *spo10, *spo01, *spo11, *spo12, *spo21, *spo22,
      *m2diag;
  const uint8_t *t2_nz, *valid_int;
  const T *multi1;  // the inside pass's multi1, [N+1][B][band]
  const T *K2;      // [ML+1][ML+1]
  const T *Kb;      // [ML+1]
  const T *Lrow;    // [band]
  // outputs: bse, bse_mism, bse_au, b_multi, b_multi2, [N+1][B][band]
  T *bse, *bse_m, *bse_a, *bmulti, *bm2;
  int64_t n1, B;
  int band, ml;
  T sig2, decay, w_mli;
};

template <typename T>
__global__ void outside_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T *sm = reinterpret_cast<T *>(smem);
  const int band = p.band, ml = p.ml, R = ml + 1, W = band - 2;
  const Layout l = layout(band, ml);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t b = blockIdx.x, B = p.B, n1 = p.n1;

  for (int k = tid; k < l.total; k += nt) sm[k] = T(0);
  __syncthreads();
  for (int k = tid; k < R * R; k += nt) sm[l.k2 + k] = p.K2[k];
  for (int k = tid; k < R; k += nt) sm[l.kb + k] = p.Kb[k];
  for (int k = tid; k < band; k += nt) sm[l.lrow + k] = p.Lrow[k];
  const T *K2 = sm + l.k2, *Kb = sm + l.kb, *Lrow = sm + l.lrow;
  T *bsew = sm + l.bsew, *bsaw = sm + l.bsaw, *bmbw = sm + l.bmbw;
  T *bser = sm + l.bse, *bst = sm + l.bst, *bm2r = sm + l.bm2;
  T *clos = sm + l.clos, *bm1 = sm + l.bm1, *bmul = sm + l.bmul;
  T *Gp = sm + l.gp, *bul = sm + l.bul;
  __syncthreads();

  for (int64_t q = n1 - 1; q >= 0; --q) {
    const int64_t row = (q * B + b) * band;
    T *bs0 = bser + (q % 3) * band;               // bse, column q
    const T *bs1 = bser + ((q + 1) % 3) * band;   // column q+1 (0 past N)
    const T *bs2 = bser + ((q + 2) % 3) * band;   // column q+2
    T *bstc = bst + (q & 1) * band;               // b_stem, column q
    const T *bstn = bst + ((q + 1) & 1) * band;   // column q+1
    T *bm2c = bm2r + (q & 1) * band;
    const T *bm2n = bm2r + ((q + 1) & 1) * band;
    const int sl = (int)(q % R);                  // window slot of column q
    const int64_t last = n1 - 1 - q;              // columns after q

    // ---- 1. bse, bse_mism, bse_au, clos ----
    for (int d = tid; d < band; d += nt) {
      const int64_t o = row + d;
      const bool vi = p.valid_int[o] != 0;
      const T nx = d + 2 < band ? bstn[d + 2] : T(0);
      const T s = (vi && d < W) ? nx * p.sig2 : T(0);
      const T sm_ = s * p.bse_mism_w[o];
      const T sa = s * p.bse_au_w[o];
      bs0[d] = s;
      bsew[sl * band + d] = sm_;
      bsaw[sl * band + d] = sa;
      clos[d] = vi ? s * p.mlclose_o[o] : T(0);
      p.bse[o] = s;
      p.bse_m[o] = sm_;
      p.bse_a[o] = sa;
    }
    __syncthreads();

    // ---- 2. Gp, bmulti, bm1 and the bulge sums ----
    const int ng = R * band;
    for (int it = tid; it < ng + 3 * band; it += nt) {
      if (it < ng) {
        // Gp[r][e], needed for e >= r only
        const int r = it / band, e = it % band;
        if (e < r) continue;
        T s = T(0);
        int slot = sl;
        for (int u = 0; u <= r && u <= last; ++u) {
          s += K2[r * R + u] * bsew[slot * band + e];
          slot = slot == R - 1 ? 0 : slot + 1;
        }
        Gp[r * band + e] = s;
      } else if (it < ng + band) {
        const int d = it - ng;
        T s = T(0);
        if (p.valid_int[row + d])
          for (int e = d; e < band; ++e) s += clos[e] * Lrow[e - d];
        bmul[d] = s;
      } else if (it < ng + 2 * band) {
        // bm1[d] = sum_{t=1..W} bmb[q+t][d+t] * multi2[q+t][t]
        const int d = it - ng - band;
        T s = T(0);
        if (p.valid_int[row + d]) {
          int slot = (int)(q % (W + 1));
          for (int t = 1; t <= W && d + t < band && t <= last; ++t) {
            slot = slot == W ? 0 : slot + 1;
            s += bmbw[slot * band + d + t] * p.m2diag[row + t];
          }
        }
        bm1[d] = s;
      } else {
        // bulges: the same column's bse_au at span d+k, and the window
        const int d = it - ng - 2 * band;
        T s1 = T(0);
        for (int k = 2; k <= ml && d + k < band; ++k)
          s1 += bsaw[sl * band + d + k] * Kb[k];
        T s2 = T(0);
        int slot = sl;
        for (int u = 0; u <= ml && d + u < band && u <= last; ++u) {
          s2 += Kb[u] * bsaw[slot * band + d + u];
          slot = slot == R - 1 ? 0 : slot + 1;
        }
        bul[d] = s1 + s2;
      }
    }
    __syncthreads();

    // ---- 3. b_multi2, b_stem ----
    const int bmslot = (int)(q % (W + 1));
    for (int d = tid; d < band; d += nt) {
      const int64_t o = row + d;
      const bool vi = p.valid_int[o] != 0;
      // same-column bifurcations: e = d + f <= W (bmb is 0 at band-1)
      T s = T(0);
      if (q - d >= 0) {
        const T *m1 = p.multi1 + ((q - d) * B + b) * band;
        for (int f = 1; f <= W && d + f < band; ++f) {
          const int e = d + f;
          const T bmb = (bm1[e] + bmul[e]) * (e < band - 1 ? T(1) : T(0));
          s += bmb * m1[f];
        }
      }
      T b2 = bm1[d] + (d + 1 < band ? bm2n[d + 1] : T(0)) * p.decay;
      b2 = b2 + s;
      b2 = vi ? b2 : T(0);

      T out = p.seed[o] * p.dangle[o];
      T gen = T(0);
      for (int r = 0; r <= ml && d + r < band; ++r) gen += Gp[r * band + d + r];
      out = out + gen * p.mism_out2[o];
      out = out + bul[d] * p.au_out2[o];
      out = out + p.spo10[o] * (d + 1 < band ? bs0[d + 1] : T(0));
      out = out + p.spo01[o] * (d + 1 < band ? bs1[d + 1] : T(0));
      out = out + p.spo11[o] * (d + 2 < band ? bs1[d + 2] : T(0));
      out = out + p.spo21[o] * (d + 3 < band ? bs1[d + 3] : T(0));
      out = out + p.spo12[o] * (d + 3 < band ? bs2[d + 3] : T(0));
      out = out + p.spo22[o] * (d + 4 < band ? bs2[d + 4] : T(0));
      out = out + (d + 2 < band ? bstn[d + 2] : T(0)) * p.contW[o];
      out = out + b2 * p.w_mli * p.dangle[o];
      bstc[d] = p.t2_nz[o] ? out : T(0);
      bm2c[d] = b2;
      bmbw[bmslot * band + d] =
          (bm1[d] + bmul[d]) * (d < band - 1 ? T(1) : T(0));
      p.bmulti[o] = bmul[d];
      p.bm2[o] = b2;
    }
    __syncthreads();
  }
}

// ptrs: the 17 grids in batched.py:OutsideGrids order (t2_nz, seed,
//   dangle_pq, bse_mism_w, bse_au_w, mism_out2, au_out2, contW, mlclose_o,
//   spo10, spo01, spo11, spo12, spo21, spo22, m2diag, valid_int), multi1,
//   K2, Kb, Lrow, bse, bse_m, bse_a, b_multi, b_multi2 (26 device pointers);
// sizes: N+1, B, band, ML, threads per block;
// scalars: sigma^-2, W_mlb sigma^-1, W_mli (each already rounded to T)
template <typename T>
int launch(void *const *ptrs, const long long *sizes, const double *scalars,
           void *stream) {
  Params<T> p;
  p.t2_nz = (const uint8_t *)ptrs[0];
  p.seed = (const T *)ptrs[1];
  p.dangle = (const T *)ptrs[2];
  p.bse_mism_w = (const T *)ptrs[3];
  p.bse_au_w = (const T *)ptrs[4];
  p.mism_out2 = (const T *)ptrs[5];
  p.au_out2 = (const T *)ptrs[6];
  p.contW = (const T *)ptrs[7];
  p.mlclose_o = (const T *)ptrs[8];
  p.spo10 = (const T *)ptrs[9];
  p.spo01 = (const T *)ptrs[10];
  p.spo11 = (const T *)ptrs[11];
  p.spo12 = (const T *)ptrs[12];
  p.spo21 = (const T *)ptrs[13];
  p.spo22 = (const T *)ptrs[14];
  p.m2diag = (const T *)ptrs[15];
  p.valid_int = (const uint8_t *)ptrs[16];
  p.multi1 = (const T *)ptrs[17];
  p.K2 = (const T *)ptrs[18];
  p.Kb = (const T *)ptrs[19];
  p.Lrow = (const T *)ptrs[20];
  p.bse = (T *)ptrs[21];
  p.bse_m = (T *)ptrs[22];
  p.bse_a = (T *)ptrs[23];
  p.bmulti = (T *)ptrs[24];
  p.bm2 = (T *)ptrs[25];
  p.n1 = sizes[0];
  p.B = sizes[1];
  p.band = (int)sizes[2];
  p.ml = (int)sizes[3];
  const int threads = (int)sizes[4];
  p.sig2 = (T)scalars[0];
  p.decay = (T)scalars[1];
  p.w_mli = (T)scalars[2];
  if (p.B == 0 || p.n1 == 0) return 0;
  const size_t bytes = (size_t)layout(p.band, p.ml).total * sizeof(T);
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (bytes > (size_t)max_smem || p.B > 0x7fffffff || threads < 32 ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidConfiguration;
  auto kern = outside_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<(int)p.B, threads, bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int access_outside_f32(void *const *ptrs, const long long *sizes,
                                  const double *scalars, void *stream) {
  return launch<float>(ptrs, sizes, scalars, stream);
}

extern "C" int access_outside_f64(void *const *ptrs, const long long *sizes,
                                  const double *scalars, void *stream) {
  return launch<double>(ptrs, sizes, scalars, stream);
}
