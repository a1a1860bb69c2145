// The accessibility DP's inside column scan and both exterior scans for
// Hopper (sm_90a): one CTA per sequence runs every column of its sequence
// in one launch, with the carry in shared memory.
//
// Replaces the XLA programs of the JAX package that compute these scans:
// the column lax.scan of priblast_tpu/accessibility/batched.py:inside_pass
// (:588; it also runs the forward exterior log1p scan) and b_outer_scan
// (:1067, the backward exterior scan). Reference semantics:
// src/raccess.cpp:99-271. The terms follow the plain PyTorch versions,
// priblast_tpu_torch/accessibility/batched.py:inside_pass and b_outer_scan,
// one for one; only the order in which a sum adds its terms differs (every
// term is a nonnegative Boltzmann weight, so that moves a result by
// rounding only). Build with -fmad=false, as the other kernels.
//
// Layout: every grid and every output plane is [N+1][B][band] (column j
// leading, span d last), as the plain version's; A and B are [N+1][B].
//
// Per column j (three stages, each ended by a block barrier):
//   1. per span d: stem (from the previous column's stem and stemend at
//      span d-2), stem_mism, stem_au, multi2 (from the previous column's
//      multi2 at span d-1);
//   2. all threads: the interior-loop contraction
//      G[r][d] = sum_u2 K2[r][u2] * stem_mism[j-u2][d] (u2 <= r, K2 being
//      zero above its diagonal), the multibif sum
//      mb[d] = sum_u multi1[j-u][d-u] * multi2[j][u] and the two bulge
//      sums; warp 0 first takes the exterior step
//      A[j] = A[j-1] + log1p(sum_dp stem[dp] ext_dot[dp] exp(A[j-dp] - A[j-1]))
//      (each exp <= 1), reduced with shuffles;
//   3. per span d: gen[d] = sum_r G[r][d-r], the small-loop specials,
//      multi[d] = sum_e mb[e] Lrow[d-e] (Lrow[k] = (W_mlb sigma^-1)^k, the
//      first row of the triangular Lmat), multi1 = multi2 + mb, stemend.
// Then warp 0 runs the backward exterior scan over the stem * ext_dot
// diagonals the CTA has written (read back from L2), and the block
// subtracts B[len] of its sequence.
//
// Shared memory (the carry, never in device memory between columns):
// the stem_mism and stem_au windows ((ML+1) x band each, a ring over
// columns), the multi1 window ((W+1) x band), the last three stem columns,
// multi2 (two buffers), stemend, mb, the bulge sums, G ((ML+1) x band), the
// ring of the last band values of A (B in the backward scan), and the
// tables K2, Kb and Lrow: ~55 KB in float, ~109 KB in double at band 72.
//
// Bound on this card: the bytes of the grids and planes, each read or
// written once, set the least time; the operations it needs (most of them
// the K2 triangle, u2 <= r and e + r < band) take less. The columns are a
// chain of dependent steps with three block barriers each, over B CTAs
// only, so the kernel is bound by the latency of one column step, far
// above either.
//
// C entry points (ctypes): access_inside_f32, access_inside_f64. They
// launch on the given stream and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// offsets (in elements of T) of the shared-memory regions
struct Layout {
  int k2, kb, lrow, smw, saw, m1w, stem, m2, stemend, mb, bul, g, awin,
      total;
};

__host__ __device__ inline Layout layout(int band, int ml) {
  const int R = ml + 1, W = band - 2;
  Layout l;
  int o = 0;
  l.k2 = o;      o += R * R;
  l.kb = o;      o += R;
  l.lrow = o;    o += band;
  l.smw = o;     o += R * band;
  l.saw = o;     o += R * band;
  l.m1w = o;     o += (W + 1) * band;
  l.stem = o;    o += 3 * band;
  l.m2 = o;      o += 2 * band;
  l.stemend = o; o += band;
  l.mb = o;      o += band;
  l.bul = o;     o += band;
  l.g = o;       o += R * band;
  l.awin = o;    o += band;
  l.total = o;
  return l;
}

template <typename T>
struct Params {
  // grids (batched.py:Grids), [N+1][B][band]
  const T *stackW, *mism_in, *au_in, *dangle, *hpW, *mism_out, *au_out,
      *mlclose, *sp10, *sp01, *sp11, *sp12, *sp21, *sp22, *ext_dot;
  const uint8_t *t1_nz, *validC;
  const T *K2;    // [ML+1][ML+1]
  const T *Kb;    // [ML+1]
  const T *Lrow;  // [band]
  const int64_t *lengths;  // [B]
  // outputs: the six planes [N+1][B][band], then A and B [N+1][B]
  T *stem, *stem_m, *stem_a, *multi, *multi1, *multi2, *A, *Bx;
  int64_t n1, B;
  int band, ml;
  T sig2, mlb_sig1, w_mli;
};

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float l1p(float x) { return log1pf(x); }
__device__ __forceinline__ double l1p(double x) { return log1p(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void inside_kernel(const Params<T> p) {
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
  T *smw = sm + l.smw, *saw = sm + l.saw, *m1w = sm + l.m1w;
  T *stemr = sm + l.stem, *m2 = sm + l.m2, *stemend = sm + l.stemend;
  T *mb = sm + l.mb, *bul = sm + l.bul, *G = sm + l.g, *awin = sm + l.awin;
  __syncthreads();

  for (int64_t j = 0; j < n1; ++j) {
    const int64_t row = (j * B + b) * band;
    T *st = stemr + (j % 3) * band;                // stem, column j
    const T *st1 = stemr + ((j + 2) % 3) * band;   // column j-1 (0 before 0)
    const T *st2 = stemr + ((j + 1) % 3) * band;   // column j-2
    T *m2c = m2 + (j & 1) * band;
    const T *m2p = m2 + ((j + 1) & 1) * band;
    const int sl = (int)(j % R);                   // window slot of column j

    // ---- 1. stem, stem_mism, stem_au, multi2 ----
    for (int d = tid; d < band; d += nt) {
      const int64_t o = row + d;
      const T sp2 = d >= 2 ? st1[d - 2] : T(0);
      const T se2 = d >= 2 ? stemend[d - 2] : T(0);
      const T inner = sp2 * p.stackW[o] + se2;
      const bool t1 = p.t1_nz[o] != 0;
      const T s = t1 ? inner * p.sig2 : T(0);
      const T sm_ = s * p.mism_in[o];
      const T sa = s * p.au_in[o];
      const T m2v = (t1 ? s * p.w_mli * p.dangle[o] : T(0))
                    + (d >= 1 ? m2p[d - 1] : T(0)) * p.mlb_sig1;
      st[d] = s;
      smw[sl * band + d] = sm_;
      saw[sl * band + d] = sa;
      m2c[d] = m2v;
      p.stem[o] = s;
      p.stem_m[o] = sm_;
      p.stem_a[o] = sa;
      p.multi2[o] = m2v;
    }
    __syncthreads();

    // ---- 2. exterior step (warp 0), then G, mb and the bulge sums ----
    if (tid < 32) {
      const T a_prev = j > 0 ? awin[(j - 1) % band] : T(0);
      T part = T(0);
      for (int dp = 1 + tid; dp < band; dp += 32) {
        const int64_t c = j - dp;                  // A[j-dp]; 0 before 0
        const T aw = c >= 0 ? awin[c % band] : T(0);
        part += (st[dp] * p.ext_dot[row + dp]) * ex(aw - a_prev);
      }
      part = warp_sum(part);
      if (tid == 0) {
        const T a = a_prev + l1p(part);
        awin[j % band] = a;
        p.A[j * B + b] = a;
      }
    }
    const int ng = R * band;
    for (int it = tid; it < ng + 2 * band; it += nt) {
      if (it < ng) {
        // G[r][e], needed for e + r < band only
        const int r = it / band, e = it % band;
        if (e + r >= band) continue;
        T s = T(0);
        int slot = sl;
        for (int u2 = 0; u2 <= r && u2 <= j; ++u2) {
          s += K2[r * R + u2] * smw[slot * band + e];
          slot = slot == 0 ? R - 1 : slot - 1;
        }
        G[r * band + e] = s;
      } else if (it < ng + band) {
        // mb[d] = sum_{u=1..min(W, d)} multi1[j-u][d-u] * multi2[j][u]
        const int d = it - ng;
        T s = T(0);
        int slot = (int)(j % (W + 1));
        for (int u = 1; u <= W && u <= d && u <= j; ++u) {
          slot = slot == 0 ? W : slot - 1;
          s += m1w[slot * band + d - u] * m2c[u];
        }
        mb[d] = s;
      } else {
        // bulges: the same column's stem_au at span d-k, and the window
        const int d = it - ng - band;
        T s1 = T(0);
        for (int k = 2; k <= ml && k <= d; ++k)
          s1 += saw[sl * band + d - k] * Kb[k];
        T s2 = T(0);
        int slot = sl;
        for (int u = 0; u <= ml && u <= d && u <= j; ++u) {
          s2 += Kb[u] * saw[slot * band + d - u];
          slot = slot == 0 ? R - 1 : slot - 1;
        }
        bul[d] = s1 + s2;
      }
    }
    __syncthreads();

    // ---- 3. stemend, multi, multi1 ----
    const int m1slot = (int)(j % (W + 1));
    for (int d = tid; d < band; d += nt) {
      const int64_t o = row + d;
      T gen = T(0);
      for (int r = 0; r <= ml && r <= d; ++r) gen += G[r * band + d - r];
      T se = p.hpW[o] + gen * p.mism_out[o];
      se = se + bul[d] * p.au_out[o];
      se = se + p.sp10[o] * (d >= 1 ? st[d - 1] : T(0));
      se = se + p.sp01[o] * (d >= 1 ? st1[d - 1] : T(0));
      se = se + p.sp11[o] * (d >= 2 ? st1[d - 2] : T(0));
      se = se + p.sp21[o] * (d >= 3 ? st1[d - 3] : T(0));
      se = se + p.sp12[o] * (d >= 3 ? st2[d - 3] : T(0));
      se = se + p.sp22[o] * (d >= 4 ? st2[d - 4] : T(0));
      T mlt = T(0);
      for (int e = 0; e <= d; ++e) mlt += mb[e] * Lrow[d - e];
      se = se + mlt * p.mlclose[o];
      stemend[d] = p.validC[o] ? se : T(0);
      const T m1 = m2c[d] + mb[d];
      m1w[m1slot * band + d] = m1;
      p.multi[o] = mlt;
      p.multi1[o] = m1;
    }
    __syncthreads();
  }

  // ---- backward exterior scan (warp 0): B[i] = B[i+1] +
  // log1p(sum_dp stem[i+dp][dp] ext_dot[i+dp][dp] exp(B[i+dp] - B[i+1])),
  // B = 0 past the last column; awin now holds B[c] at c % band ----
  if (tid < 32) {
    T b_next = T(0);
    for (int64_t i = n1 - 1; i >= 0; --i) {
      T part = T(0);
      for (int dp = 1 + tid; dp < band && i + dp < n1; dp += 32) {
        const int64_t c = i + dp, o = (c * B + b) * band + dp;
        part += (p.stem[o] * p.ext_dot[o]) * ex(awin[c % band] - b_next);
      }
      part = warp_sum(part);
      const T bc = b_next + l1p(part);
      if (tid == 0) {
        awin[i % band] = bc;
        p.Bx[i * B + b] = bc;
      }
      __syncwarp();
      b_next = bc;
    }
  }
  __syncthreads();
  // columns past the sequence's end read B[len] (their stems are 0):
  // subtract it, so that B[len] = 0
  const T offs = p.Bx[p.lengths[b] * B + b];
  __syncthreads();
  for (int64_t i = tid; i < n1; i += nt) p.Bx[i * B + b] -= offs;
}

// ptrs: the 17 grids in batched.py:Grids order (stackW, t1_nz, mism_in,
//   au_in, dangle_ij, validC, hpW, mism_out, au_out, mlclose, sp10, sp01,
//   sp11, sp12, sp21, sp22, ext_dot), K2, Kb, Lrow, lengths, stem, stem_m,
//   stem_a, multi, multi1, multi2, A, B (29 device pointers);
// sizes: N+1, B, band, ML, threads per block;
// scalars: sigma^-2, W_mlb sigma^-1, W_mli (each already rounded to T)
template <typename T>
int launch(void *const *ptrs, const long long *sizes, const double *scalars,
           void *stream) {
  Params<T> p;
  p.stackW = (const T *)ptrs[0];
  p.t1_nz = (const uint8_t *)ptrs[1];
  p.mism_in = (const T *)ptrs[2];
  p.au_in = (const T *)ptrs[3];
  p.dangle = (const T *)ptrs[4];
  p.validC = (const uint8_t *)ptrs[5];
  p.hpW = (const T *)ptrs[6];
  p.mism_out = (const T *)ptrs[7];
  p.au_out = (const T *)ptrs[8];
  p.mlclose = (const T *)ptrs[9];
  p.sp10 = (const T *)ptrs[10];
  p.sp01 = (const T *)ptrs[11];
  p.sp11 = (const T *)ptrs[12];
  p.sp12 = (const T *)ptrs[13];
  p.sp21 = (const T *)ptrs[14];
  p.sp22 = (const T *)ptrs[15];
  p.ext_dot = (const T *)ptrs[16];
  p.K2 = (const T *)ptrs[17];
  p.Kb = (const T *)ptrs[18];
  p.Lrow = (const T *)ptrs[19];
  p.lengths = (const int64_t *)ptrs[20];
  p.stem = (T *)ptrs[21];
  p.stem_m = (T *)ptrs[22];
  p.stem_a = (T *)ptrs[23];
  p.multi = (T *)ptrs[24];
  p.multi1 = (T *)ptrs[25];
  p.multi2 = (T *)ptrs[26];
  p.A = (T *)ptrs[27];
  p.Bx = (T *)ptrs[28];
  p.n1 = sizes[0];
  p.B = sizes[1];
  p.band = (int)sizes[2];
  p.ml = (int)sizes[3];
  const int threads = (int)sizes[4];
  p.sig2 = (T)scalars[0];
  p.mlb_sig1 = (T)scalars[1];
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
  auto kern = inside_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<(int)p.B, threads, bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int access_inside_f32(void *const *ptrs, const long long *sizes,
                                 const double *scalars, void *stream) {
  return launch<float>(ptrs, sizes, scalars, stream);
}

extern "C" int access_inside_f64(void *const *ptrs, const long long *sizes,
                                 const double *scalars, void *stream) {
  return launch<double>(ptrs, sizes, scalars, stream);
}
