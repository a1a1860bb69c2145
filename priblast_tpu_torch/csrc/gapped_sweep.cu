// Gapped-extension diagonal sweep for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel _sweep_kernel
// (priblast_tpu/search/gapped_pl.py:51). Reference semantics:
// src/gapped_extension.cpp:213-319. Arithmetic follows the plain PyTorch
// version in ops/gapped_sweep.py (sweep_plain) operation for operation, so
// both produce the same bits; build with -fmad=false so no multiply-add is
// contracted.
//
// Mapping: one thread block per hit, one thread per cell i of a diagonal
// (blockDim = W rounded up to a warp). The diagonal loop L = 1..max_ext runs
// inside the block. The rings of the last RH = dropout + 2 diagonals (hyb,
// admission, VM, ZW, AU), the predecessor-type bits of the last two
// diagonals and the hit's prefix chains live in shared memory; per diagonal
// a thread reads only its own lane of the current plane rows from device
// memory (coalesced: the planes are hit-major, lane-minor) and writes its
// lane of the predecessor row. The diagonal minimum / argmin and the
// stems[0] first-admitted pick are block reductions with the reference's
// tie rules (smallest lane on equal minima; smallest (row, lane) code).
//
// Bound on this card: device-memory bytes (plane rows in, predecessor rows
// out); the 153-combo scan per cell runs on shared memory and registers.
//
// C entry points (ctypes): gapped_sweep_f32 / gapped_sweep_f64. They launch
// on the given stream and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// float plane rows per diagonal, in the order of ops/gapped_sweep.py (MS,
// SPECIAL, VM): MS, the seven special (u1, u2) loop energies, VM
constexpr int kNF = 9;
constexpr int kMS = 0, kVM = 8;   // MS and VM plane indices
constexpr int kNZ0 = 1, kW0 = 2, kAU0 = 4, kBAD = 8;
constexpr int kBigPick = 1 << 30;

template <typename T>
__device__ __forceinline__ T inf_of();
template <>
__device__ __forceinline__ float inf_of<float>() { return __int_as_float(0x7f800000); }
template <>
__device__ __forceinline__ double inf_of<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

__device__ __forceinline__ bool is_inf(float x) { return isinf(x); }
__device__ __forceinline__ bool is_inf(double x) { return isinf(x); }

// smallest (value, index) pair: smaller value, then smaller index
template <typename T>
__device__ __forceinline__ void min_pair(T &v, int &k, T ov, int ok) {
  if (ov < v || (ov == v && ok < k)) {
    v = ov;
    k = ok;
  }
}

template <typename T>
__global__ void sweep_kernel(const T *__restrict__ fplanes,
                             const int32_t *__restrict__ iplanes,
                             const T *__restrict__ extq_g,
                             const T *__restrict__ extdb_g,
                             const int32_t *__restrict__ hit_i,
                             const T *__restrict__ hit_f,
                             const T *__restrict__ consts,
                             int32_t *__restrict__ pred,
                             int32_t *__restrict__ ints,
                             T *__restrict__ floats, int dropout,
                             int max_ext, int XW, T tau) {
  const int W = max_ext;
  const int ME1 = max_ext + 1;
  const int RH = dropout + 2;
  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const bool lane_ok = i < W;
  const int nwarps = (blockDim.x + 31) / 32;
  const int warp = i >> 5;
  const int wl = i & 31;
  const T INF = inf_of<T>();

  // ---- shared memory layout -------------------------------------------
  extern __shared__ __align__(16) unsigned char smem[];
  T *ring_h = reinterpret_cast<T *>(smem);          // [RH][W]
  T *ring_vm = ring_h + RH * W;                     // [RH][W]
  T *extq = ring_vm + RH * W;                       // [XW]
  T *extdb = extq + XW;                             // [XW]
  T *red_v = extdb + XW;                            // [nwarps]
  T *cst = red_v + nwarps;                          // [2][dropout+1]
  int *ring_zw = reinterpret_cast<int *>(cst + 2 * (dropout + 1));  // [RH][W]
  int *red_k = ring_zw + RH * W;                    // [nwarps]
  int *red_p = red_k + nwarps;                      // [nwarps]
  unsigned char *ring_a = reinterpret_cast<unsigned char *>(red_p + nwarps);
  unsigned char *ring_au = ring_a + RH * W;         // [RH][W]
  unsigned char *mt = ring_au + RH * W;             // [4][W]: z-1, w-1, z0, w0

  const int32_t *hi = hit_i + 4 * b;
  const int maxq = hi[0], maxd = hi[1];
  const bool valid = hi[2] != 0;
  const int obits = hi[3];
  const T energy0 = hit_f[2 * b], acc0 = hit_f[2 * b + 1];
  const T *fp = fplanes + (size_t)b * kNF * ME1 * W;
  const int32_t *ip = iplanes + (size_t)b * ME1 * W;
  int32_t *pr = pred + (size_t)b * ME1 * W;

  // ---- init: rings (diagonals < 0 empty), origin cell at diagonal 0 ---
  for (int k = i; k < RH * W; k += blockDim.x) {
    ring_h[k] = INF;
    ring_vm[k] = T(0);
    ring_zw[k] = 0;
    ring_a[k] = 0;
    ring_au[k] = 0;
  }
  for (int k = i; k < XW; k += blockDim.x) {
    extq[k] = extq_g[(size_t)b * XW + k];
    extdb[k] = extdb_g[(size_t)b * XW + k];
  }
  for (int k = i; k < 2 * (dropout + 1); k += blockDim.x) cst[k] = consts[k];
  if (lane_ok) {
    mt[i] = 1;          // diagonal -1: every cell type 0
    mt[W + i] = 0;
    mt[2 * W + i] = (i == 0) ? (unsigned char)((obits & 1) != 0) : 1;
    mt[3 * W + i] = (i == 0) ? (unsigned char)((obits & 2) != 0) : 0;
  }
  __syncthreads();
  if (i == 0) {
    const int p0 = 0;  // ring row of diagonal 0
    ring_h[p0 * W] = valid ? energy0 : INF;
    ring_a[p0 * W] = valid ? 1 : 0;
  }
  // (the init stores are made visible by the first sync of the loop)

  bool active = valid;
  bool ovf = false;
  T min_e = energy0, min_a = acc0;
  int min_i = 0, min_j = 0, min_len = 0, n_diag = 0;
  const T hundred = T(100);

  for (int L = 1; L <= max_ext && active; ++L) {
    n_diag = L;
    // ---- ring inserts: previous diagonal's VM / ZW / AU rows ----------
    const int prow = (L - 1) % RH;
    T ms = T(0);
    T spec[8];
    int bits_c = 0;
    T extdb_j = INF;
    if (lane_ok) {
      const size_t prev = (size_t)(L - 1) * W + i;
      ring_vm[prow * W + i] = fp[(size_t)kVM * ME1 * W + prev];
      const int pb = ip[prev];
      ring_zw[prow * W + i] = ((pb & kNZ0) ? 0 : 16384) | ((pb & kW0) ? 32768 : 0);
      ring_au[prow * W + i] = (pb & kAU0) ? 1 : 0;
      const size_t cur = (size_t)L * W + i;
      bits_c = ip[cur];
      ms = fp[(size_t)kMS * ME1 * W + cur];
#pragma unroll
      for (int k = 1; k < 8; ++k) spec[k] = fp[(size_t)k * ME1 * W + cur];
      if (L - i >= 0) extdb_j = extdb[L - i];
    }
    __syncthreads();

    // ---- stems[0] fallback bits: first admitted cell in (row, lane) ----
    int pick = kBigPick;
    if (lane_ok) {
      for (int r = 0; r < RH; ++r) {
        const int row = (L + r) % RH;  // diagonal L - RH + r
        if (ring_a[row * W + i]) {
          const int zw = ring_zw[row * W + i];
          pick = (r * W + i) * 4 + ((zw & 16384) ? 2 : 0) + ((zw & 32768) ? 1 : 0);
          break;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      pick = min(pick, __shfl_xor_sync(0xffffffffu, pick, off));
    if (wl == 0) red_p[warp] = pick;

    // ---- helix/wobble admission ----------------------------------------
    const bool nz0 = bits_c & kNZ0, w0 = bits_c & kW0;
    const bool au0 = bits_c & kAU0, badr = bits_c & kBAD;
    const bool prev_z = (i == 0 || !lane_ok) ? true : (mt[i - 1] != 0);
    const bool prev_w = (i == 0 || !lane_ok) ? false : (mt[W + i - 1] != 0);
    const bool gate = prev_z || (w0 && prev_w);
    const bool cellmask = lane_ok && i >= 1 && i <= L - 1 && i <= maxq &&
                          (L - i) <= maxd;
    const bool adm_new = cellmask && nz0 && !(gate && badr);

    // ---- combo minimum in stems-list order (strict <: first wins) ------
    const T au_f = au0 ? tau : T(0);
    const int base_pk = i * max_ext + L;
    T run_min = INF;
    int run_pay = 0;
    if (lane_ok) {
      for (int s = dropout; s >= 0; --s) {
        const int r = dropout - s;
        const int row = (L + r) % RH;  // diagonal L - s - 2
        const T *rh = ring_h + row * W;
        for (int u1 = s; u1 >= 0; --u1) {
          const int u2 = s - u1;
          const int k = i - (u1 + 1);  // predecessor lane
          const T ph = (k >= 0) ? rh[k] : INF;
          T Et;
          const bool small = (u1 == 1 || u1 == 2) && (u2 == 1 || u2 == 2);
          if (s >= 2 && u1 >= 1 && u2 >= 1 && !small) {
            const T vm = (k >= 0) ? ring_vm[row * W + k] : T(0);
            const T raw = (ms + cst[s]) + vm;
            Et = raw / hundred + ph;
          } else if (s >= 2 && (u1 == 0 || u2 == 0)) {
            const bool aup = (k >= 0) ? (ring_au[row * W + k] != 0) : false;
            const T au_p = aup ? tau : T(0);
            Et = (au_f + cst[dropout + 1 + s] + au_p) / hundred + ph;
          } else {
            int sp;
            if (u1 == 0 && u2 == 0) sp = 1;
            else if (u1 == 1 && u2 == 0) sp = 2;
            else if (u1 == 0 && u2 == 1) sp = 3;
            else if (u1 == 1 && u2 == 1) sp = 4;
            else if (u1 == 1 && u2 == 2) sp = 5;
            else if (u1 == 2 && u2 == 1) sp = 6;
            else sp = 7;
            Et = spec[sp] + ph;
          }
          if (Et < run_min) {
            const int zw = (k >= 0) ? ring_zw[row * W + k] : 0;
            run_min = Et;
            run_pay = zw + (base_pk - ((u1 + 1) * ME1 + u2 + 1));
          }
        }
      }
    }
    __syncthreads();  // red_p complete
    int pick_all = kBigPick;
    for (int w = 0; w < nwarps; ++w) pick_all = min(pick_all, red_p[w]);
    const bool any_adm = pick_all < kBigPick;
    const bool stem0_z = any_adm ? (((pick_all >> 1) & 1) != 0) : true;
    const bool stem0_w = any_adm ? ((pick_all & 1) != 0) : false;

    const bool nopred = is_inf(run_min);
    const int pay = run_pay > 0 ? run_pay : 0;
    const bool mtz_c = nopred ? stem0_z : ((pay & 16384) != 0);
    const bool mtw_c = nopred ? stem0_w : ((pay & 32768) != 0);
    const int packed = nopred ? 0 : (pay & 16383);
    const T hyb_row = adm_new ? run_min : INF;
    const bool mtz_row = adm_new ? mtz_c : true;
    const bool mtw_row = adm_new ? mtw_c : false;

    // ---- running minimum over the diagonal -----------------------------
    T inter = INF;
    if (adm_new) inter = (extq[i] + extdb_j) + run_min;
    T v = inter;
    int arg = lane_ok ? i : kBigPick;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int ok = __shfl_xor_sync(0xffffffffu, arg, off);
      min_pair(v, arg, ov, ok);
    }
    if (wl == 0) {
      red_v[warp] = v;
      red_k[warp] = arg;
    }
    __syncthreads();  // every thread is done reading rings and mt
    T dmin = red_v[0];
    int darg = red_k[0];
    for (int w = 1; w < nwarps; ++w) min_pair(dmin, darg, red_v[w], red_k[w]);
    if (is_inf(dmin)) darg = 0;  // all-INF diagonal: argmin is lane 0

    const bool improve = active && (dmin < min_e);
    if (improve) {
      min_e = dmin;
      min_i = darg;
      min_j = L - darg;
      min_len = L;
      int dj = L - darg;
      dj = dj < 0 ? 0 : (dj > XW - 1 ? XW - 1 : dj);
      min_a = (acc0 + extq[darg]) + extdb[dj];
    }

    // ---- termination -----------------------------------------------------
    const bool stop = (L - min_len >= dropout) || ((L > maxq) && (L > maxd));
    ovf = ovf || (active && !stop && (L >= max_ext));
    active = active && !stop && (L < max_ext);

    // ---- state / ring updates and the predecessor row ------------------
    if (lane_ok) {
      const int crow = L % RH;
      ring_h[crow * W + i] = hyb_row;
      ring_a[crow * W + i] = adm_new ? 1 : 0;
      mt[i] = mt[2 * W + i];
      mt[W + i] = mt[3 * W + i];
      mt[2 * W + i] = mtz_row ? 1 : 0;
      mt[3 * W + i] = mtw_row ? 1 : 0;
      pr[(size_t)L * W + i] = adm_new ? packed : -1;
    }
    // the next diagonal's first sync orders these writes before its reads
  }

  if (i == 0) {
    int32_t *io = ints + 5 * b;
    io[0] = min_i;
    io[1] = min_j;
    io[2] = min_len;
    io[3] = ovf ? 1 : 0;
    io[4] = n_diag;
    floats[2 * b] = min_e;
    floats[2 * b + 1] = min_a;
  }
}

template <typename T>
size_t smem_bytes(int dropout, int W, int XW, int nwarps) {
  const int RH = dropout + 2;
  size_t n = sizeof(T) * (2 * RH * W + 2 * XW + nwarps + 2 * (dropout + 1));
  n += sizeof(int) * (RH * W + 2 * nwarps);
  n += 2 * RH * W + 4 * W;
  return n;
}

template <typename T>
int launch(const void *fplanes, const void *iplanes, const void *extq,
           const void *extdb, const void *hit_i, const void *hit_f,
           const void *consts, void *pred, void *ints, void *floats, int B,
           int dropout, int max_ext, int XW, double tau, void *stream) {
  const int threads = ((max_ext + 31) / 32) * 32;
  const int nwarps = threads / 32;
  const size_t smem = smem_bytes<T>(dropout, max_ext, XW, nwarps);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sweep_kernel<T><<<B, threads, smem, (cudaStream_t)stream>>>(
      (const T *)fplanes, (const int32_t *)iplanes, (const T *)extq,
      (const T *)extdb, (const int32_t *)hit_i, (const T *)hit_f,
      (const T *)consts, (int32_t *)pred, (int32_t *)ints, (T *)floats,
      dropout, max_ext, XW, (T)tau);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gapped_sweep_f32(const void *fplanes, const void *iplanes,
                                const void *extq, const void *extdb,
                                const void *hit_i, const void *hit_f,
                                const void *consts, void *pred, void *ints,
                                void *floats, int B, int dropout,
                                int max_ext, int XW, double tau,
                                void *stream) {
  return launch<float>(fplanes, iplanes, extq, extdb, hit_i, hit_f, consts,
                       pred, ints, floats, B, dropout, max_ext, XW, tau,
                       stream);
}

extern "C" int gapped_sweep_f64(const void *fplanes, const void *iplanes,
                                const void *extq, const void *extdb,
                                const void *hit_i, const void *hit_f,
                                const void *consts, void *pred, void *ints,
                                void *floats, int B, int dropout,
                                int max_ext, int XW, double tau,
                                void *stream) {
  return launch<double>(fplanes, iplanes, extq, extdb, hit_i, hit_f, consts,
                        pred, ints, floats, B, dropout, max_ext, XW, tau,
                        stream);
}
