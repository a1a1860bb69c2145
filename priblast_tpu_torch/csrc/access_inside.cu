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
// Bound on this card: the bytes of the grids and planes, each read or
// written once, set the least time; the operations it needs (most of them
// the K2 triangle, u2 <= r) take less. The columns are a chain of
// dependent steps over B CTAs only, so the latency of one column step sets
// the time: the issue slots and dependent latencies of its 24 warps, not
// bytes. The design keeps that step short:
// - the column's path holds only what depends on the column's own stems:
//   stem[j-1] and stemend[j-1] -> stem, stem_mism, stem_au, multi2 ->
//   the multibif sum mb and the same column's bulge terms -> multi and
//   stemend. Everything else runs beside it as warp tasks: the interior
//   contraction gen, whose terms all read earlier columns (K2's column
//   u2 = 0 is zero by construction: K_int has u1, u2 >= 1, a loop with no
//   unpaired base on one side being a bulge, accessibility/linear_ref.py),
//   the bulge window, and the forward exterior step, a column late;
// - two barriers per column: a span's stemend and stem feed the next
//   column's stems at span d+2 in the same lane, so the stems need no
//   stage of their own;
// - no device memory on the column's path: the 17 grid rows of column j+2
//   are loaded while column j computes (registers, then shared memory at
//   the end of column j+1's first stage; three buffers);
// - no span sum left to one thread: every sum over a span's terms is split
//   over kParts lanes (strided terms) and reduced with __shfl_xor_sync;
// - the window contraction genw[d] = sum_{u2>=1} sum_{r>=u2} K2[r][u2]
//   stem_mism[j-u2][d-r] runs as warp tasks with no divergence and one K2
//   read for three terms (lanes d, d+32, d+64 over rows zero-padded in
//   front), in kChunks chunks over the two stages before its column;
// - every loop has its trip count set before it starts, so that it
//   unrolls and its loads issue together; the column's ring slots are
//   counters, with no 64-bit division on the path;
// - the backward exterior scan (a chain of n1 dependent steps on one warp)
//   reads the stem * ext_dot products of kSteps steps at a time from
//   shared memory, loaded row by row (coalesced) by the other warps while
//   warp 0 runs the steps before them.
//
// Per column j, two stages, each ended by a block barrier; warp w takes a
// stage's 32-lane blocks w, w + warps, ... (every task's item count is
// padded to 32, so a warp never straddles two tasks):
//   1. mb[d] = sum_u multi1[j-u][d-u] multi2[j][u]; the same column's
//      bulge terms sum_{k>=2} stem_au[j][d-k] Kb[k] + Kb[0] stem_au[j][d]
//      plus the window, and gen, the sum of genw's chunks; the exterior
//      step of column j-1, A[j-1] = A[j-2] + log1p(sum_dp stem[j-1][dp]
//      ext_dot[j-1][dp] exp(A[j-1-dp] - A[j-2])) (each exp <= 1; A = 0
//      before column 0), reduced with shuffles; kB chunks of column j+1's
//      genw; column j+1's grid rows into shared memory;
//   2. per span d: multi[d] = sum_e mb[e] Lrow[d-e] (Lrow[k] = (W_mlb
//      sigma^-1)^k, the first row of the triangular Lmat), the small-loop
//      specials, stemend, multi1 = multi2 + mb; then column j+1's stem
//      (from this span's stem and stemend), stem_mism, stem_au and multi2
//      (from column j's multi2 at span d+1) at span d+2, spans 0 and 1 by
//      the last two spans' lanes; column j+1's bulge window
//      sum_{u>=1} Kb[u] stem_au[j+1-u][d-u]; kC chunks of column j+1's
//      genw.
// Column 0's stems come before the loop. After the last column: its
// exterior step, then the backward exterior scan, and the block subtracts
// B[len] of its sequence.
//
// Shared memory (the carry, never in device memory between columns): the
// stem_mism and stem_au windows ((ML+1) rows each, zero in front of span
// 0), rings over columns; the multi1 window ((W+1) x band); three buffers
// of the 17 grid rows; the last four stem columns, multi2 (two buffers),
// mb, gen, the bulge sums; genw's partial sums (two columns x kChunks x
// band); the ring of the last band values of A (B in the backward scan);
// the tables K2, Kb and Lrow: ~88 KB in float, ~176 KB in double at band
// 72. The backward scan's step buffers reuse the windows.
//
// C entry points (ctypes): access_inside_f32, access_inside_f64. They
// launch on the given stream and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

#ifdef ACCESS_STAMPS
// A build with -DACCESS_STAMPS (access_ab.py; never the wrapper's) stamps
// every block barrier of the column loop and the end of the backward
// exterior scan: per stage, the SM cycles from the previous barrier's exit
// (thread 0) to the last thread's arrival (work), and from that arrival to
// thread 0's exit (barrier), summed over every column (the backward scan:
// once per CTA) of every CTA; access_inside_stamps reads and clears the
// sums.
constexpr int kStages = 3;
__device__ unsigned long long g_stamps[2 * kStages + 1];

struct Stamps {
  unsigned long long *arrive;  // shared, one slot per stage
  long long prev, work[kStages], wait[kStages];

  __device__ void start(unsigned long long *slots) {
    arrive = slots;
    if (threadIdx.x < kStages) arrive[threadIdx.x] = 0;
    __syncthreads();
    prev = clock64();
    for (int k = 0; k < kStages; ++k) work[k] = wait[k] = 0;
  }
  __device__ void sync(int k) {
    atomicMax(arrive + k, (unsigned long long)clock64());
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long t = clock64(), a = (long long)arrive[k];
      work[k] += a - prev;
      wait[k] += t - a;
      prev = t;
      arrive[k] = 0;  // read again only after the other stages' barriers
    }
  }
  __device__ void finish(long long columns) {
    if (threadIdx.x != 0) return;
    for (int k = 0; k < kStages; ++k) {
      atomicAdd(g_stamps + k, (unsigned long long)work[k]);
      atomicAdd(g_stamps + kStages + k, (unsigned long long)wait[k]);
    }
    atomicAdd(g_stamps + 2 * kStages, (unsigned long long)columns);
  }
};
#define STAGE_END(k) stamps.sync(k)
#else
#define STAGE_END(k) __syncthreads()
#endif

constexpr int kMaxThreads = 1024;  // launch bound: at most 64 registers
constexpr int kParts = 2;    // lanes per span of a split span sum
// genw's chunks (warp tasks), for the next column: kB of them in stage 1,
// kC in stage 2
constexpr int kB = 12, kC = 12, kChunks = kB + kC;
// steps of the backward exterior scan staged in shared memory at a time
constexpr int kSteps = 64;

// the grid rows of a column, in shared memory in this order
constexpr int kGrids = 17;
enum { STACKW, T1NZ, MISM_IN, AU_IN, DANGLE, VALIDC, HPW, MISM_OUT, AU_OUT,
       MLCLOSE, SP10, SP01, SP11, SP12, SP21, SP22, EXT_DOT };

// offsets (in elements of T) of the shared-memory regions
struct Layout {
  int k2, kb, lrow, awin, smw, saw, m1w, gb, stem, m2, mb, gen, bul, bw, gw,
      chunk, total;
};

// row stride of the stem_mism and stem_au windows: span e at ML + e, zero
// in front (e < 0); a warp's lanes run spans d, d+32, d+64
__host__ __device__ inline int xstride(int band, int ml) {
  return (band + 95) / 96 * 96 + ml;
}

__host__ __device__ inline Layout layout(int band, int ml) {
  const int R = ml + 1, W = band - 2;
  Layout l;
  int o = 0;
  l.k2 = o;      o += R * R;
  l.kb = o;      o += R;
  l.lrow = o;    o += band;
  l.awin = o;    o += band;
  l.smw = o;     o += R * xstride(band, ml);
  l.saw = o;     o += R * xstride(band, ml);
  l.m1w = o;     o += (W + 1) * band;
  l.gb = o;      o += 3 * kGrids * band;
  l.stem = o;    o += 4 * band;
  l.m2 = o;      o += 2 * band;
  l.mb = o;      o += band;
  l.gen = o;     o += band;
  l.bul = o;     o += band;
  l.bw = o;      o += band;
  l.gw = o;      o += 2 * kChunks * band;
  l.chunk = o;   o += 2 * (kChunks + 1);  // genw's chunk bounds, as int
  // the backward scan's two step buffers reuse smw onwards
  l.total = o > l.smw + 2 * kSteps * band ? o : l.smw + 2 * kSteps * band;
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
  // genw's chunk c runs the (u2, r) pairs, u2 = 1..ML, r = u2..ML in that
  // order, from (cu[c], cr[c]) to (cu[c+1], cr[c+1]), exclusive
  int cu[kChunks + 1], cr[kChunks + 1];
  T sig2, mlb_sig1, w_mli;
};

// the 17 grids of one cell, in the enum's order
template <typename T>
__device__ inline void load_cell(const Params<T> &p, int64_t o, T *v) {
  v[STACKW] = p.stackW[o];
  v[T1NZ] = p.t1_nz[o] ? T(1) : T(0);
  v[MISM_IN] = p.mism_in[o];
  v[AU_IN] = p.au_in[o];
  v[DANGLE] = p.dangle[o];
  v[VALIDC] = p.validC[o] ? T(1) : T(0);
  v[HPW] = p.hpW[o];
  v[MISM_OUT] = p.mism_out[o];
  v[AU_OUT] = p.au_out[o];
  v[MLCLOSE] = p.mlclose[o];
  v[SP10] = p.sp10[o];
  v[SP01] = p.sp01[o];
  v[SP11] = p.sp11[o];
  v[SP12] = p.sp12[o];
  v[SP21] = p.sp21[o];
  v[SP22] = p.sp22[o];
  v[EXT_DOT] = p.ext_dot[o];
}

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float l1p(float x) { return log1pf(x); }
__device__ __forceinline__ double l1p(double x) { return log1p(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum of a span's kParts partial sums (kParts consecutive lanes of a
// warp); every lane of the warp calls it
template <typename T>
__device__ inline T part_sum(T s) {
  for (int off = 1; off < kParts; off <<= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

__device__ inline int pad32(int n) { return (n + 31) & ~31; }

template <typename T>
__global__ void
#ifndef ACCESS_STAMPS
__launch_bounds__(kMaxThreads)
#else  // the stamps' registers would spill under the bound of 1024
__launch_bounds__(768)
#endif
    inside_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T *sm = reinterpret_cast<T *>(smem);
  const int band = p.band, ml = p.ml, R = ml + 1, W = band - 2;
  const int xs = xstride(band, ml);
  const Layout l = layout(band, ml);
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5, nwarp = nt >> 5;
  const int64_t b = blockIdx.x, B = p.B, n1 = p.n1;

  for (int k = tid; k < l.total; k += nt) sm[k] = T(0);
  __syncthreads();
  const T *K2 = sm + l.k2, *Kb = sm + l.kb, *Lrow = sm + l.lrow;
  T *awin = sm + l.awin, *smw = sm + l.smw, *saw = sm + l.saw;
  T *m1w = sm + l.m1w, *gb = sm + l.gb;
  T *stemr = sm + l.stem, *m2 = sm + l.m2;
  T *mb = sm + l.mb, *gen = sm + l.gen, *bul = sm + l.bul, *bw = sm + l.bw;
  T *gw = sm + l.gw;
  for (int k = tid; k < R * R; k += nt) sm[l.k2 + k] = p.K2[k];
  for (int k = tid; k < R; k += nt) sm[l.kb + k] = p.Kb[k];
  for (int k = tid; k < band; k += nt) sm[l.lrow + k] = p.Lrow[k];
  int *cu = reinterpret_cast<int *>(sm + l.chunk), *cr = cu + kChunks + 1;
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c <= kChunks; ++c) {
      cu[c] = p.cu[c];
      cr[c] = p.cr[c];
    }
  }
  for (int d = tid; d < band; d += nt) {  // column 0's grid rows
    T v[kGrids];
    load_cell(p, b * band + d, v);
#pragma unroll
    for (int i = 0; i < kGrids; ++i) gb[i * band + d] = v[i];
  }
  __syncthreads();

  // genw's chunk c for column qc into its column's partial sums, by one
  // warp: a lane runs spans d, d+32 and d+64 (the K2 read is a broadcast
  // and serves three terms; the rows are zero in front of span 0, so no
  // lane has a span bound and the warp never diverges). Every loop below
  // has its trip count set before it starts, so that it unrolls and its
  // loads issue together.
  auto genw_chunk = [=](int qc, int sq, int c) {  // sq: qc's window slot
    const int u0 = cu[c], ue = cu[c + 1];
    const int u1 = min(min(ue, ml), qc);  // columns >= 0
    T *out = gw + (qc & 1) * kChunks * band + c * band;
    for (int d = lane; d < band; d += 96) {
      T s0 = T(0), s1 = T(0), s2 = T(0);
      int slot = sq - u0 < 0 ? sq - u0 + R : sq - u0;
      for (int u = u0; u <= u1; ++u) {
        const T *x = smw + slot * xs + ml + d, *k2 = K2 + u;
        const int r1 = u == ue ? cr[c + 1] : ml + 1;
#pragma unroll 4
        for (int r = u == u0 ? cr[c] : u; r < r1; ++r) {
          const T k = k2[r * R];
          s0 += k * x[-r];
          s1 += k * x[32 - r];
          s2 += k * x[64 - r];
        }
        slot = slot == 0 ? R - 1 : slot - 1;
      }
      out[d] = s0;
      if (d + 32 < band) out[d + 32] = s1;
      if (d + 64 < band) out[d + 64] = s2;
    }
  };
  // the forward exterior step of column c, by one warp:
  // A[c] = A[c-1] + log1p(sum_dp stem[c][dp] ext_dot[c][dp]
  //                       exp(A[c-dp] - A[c-1])), A = 0 before column 0
  auto a_step = [=](int c, int ca, const T *stc, const T *ext) {
    // ca = c % band, A[c]'s slot in awin
    const T a_prev = c > 0 ? awin[ca == 0 ? band - 1 : ca - 1] : T(0);
    T part = T(0);
    for (int dp = 1 + lane; dp < band; dp += 32) {
      const T aw = dp <= c ? awin[ca - dp < 0 ? ca - dp + band : ca - dp]
                           : T(0);
      part += (stc[dp] * ext[dp]) * ex(aw - a_prev);
    }
    part = warp_sum(part);
    if (lane == 0) {
      const T a = a_prev + l1p(part);
      awin[ca] = a;
      p.A[(int64_t)c * B + b] = a;
    }
  };
  const int nsp = pad32(kParts * band), nspw = nsp / 32;
  // the stems of column c at span t, from column c-1's stem and stemend at
  // span t-2 (sp2, se2) and its multi2 at span t-1
  auto stem_cell = [=](int c, int gs, int slot, int t, T sp2, T se2) {
    // gs, slot: column c's grid buffer and window slot
    const T *gcol = gb + gs * kGrids * band;
    const int64_t o = ((int64_t)c * B + b) * band + t;
    const T inner = sp2 * gcol[STACKW * band + t] + se2;
    const bool t1 = gcol[T1NZ * band + t] != T(0);
    const T s = t1 ? inner * p.sig2 : T(0);
    const T sm_ = s * gcol[MISM_IN * band + t];
    const T sa = s * gcol[AU_IN * band + t];
    const T m2v = (t1 ? s * p.w_mli * gcol[DANGLE * band + t] : T(0))
                  + (t >= 1 ? m2[((c + 1) & 1) * band + t - 1] : T(0))
                    * p.mlb_sig1;
    stemr[(c & 3) * band + t] = s;
    smw[slot * xs + ml + t] = sm_;
    saw[slot * xs + ml + t] = sa;
    m2[(c & 1) * band + t] = m2v;
    p.stem[o] = s;
    p.stem_m[o] = sm_;
    p.stem_a[o] = sa;
    p.multi2[o] = m2v;
  };
  // column 0's stems (column -1 is zero); column 1's grid rows into
  // registers, stored at the end of column 0's stage 1
  for (int t = tid; t < band; t += nt) stem_cell(0, 0, 0, t, T(0), T(0));
  T gnext[kGrids];
  if (tid < band && n1 > 1) load_cell(p, (B + b) * band + tid, gnext);
  __syncthreads();
#ifdef ACCESS_STAMPS
  __shared__ unsigned long long arrive[kStages];
  Stamps stamps;
  stamps.start(arrive);
#endif

  // column j's slots: window (mod R), multi1 (mod W+1), grid rows (mod 3),
  // A (mod band); those of column j+1
  int sl = 0, m1slot = 0, gs = 0, ja = 0;
  for (int j = 0; j < (int)n1; ++j) {
    const int64_t row = ((int64_t)j * B + b) * band;
    const int sl1 = sl == R - 1 ? 0 : sl + 1, gs1 = gs == 2 ? 0 : gs + 1;
    const T *st = stemr + (j & 3) * band;          // stem, column j
    const T *st1 = stemr + ((j + 3) & 3) * band;   // column j-1 (0 before 0)
    const T *st2 = stemr + ((j + 2) & 3) * band;   // column j-2
    const T *m2c = m2 + (j & 1) * band;
    const T *gc = gb + gs * kGrids * band;         // grid rows, column j
#define G_(i, d) gc[(i) * band + (d)]

    // ---- 1. mb; the same column's bulge terms and gen; A[j-1]; genw ----
    for (int blk = warp; blk < 2 * nspw + 1 + kB; blk += nwarp) {
      if (blk < nspw) {
        // mb[d] = sum_{u=1..min(W, d)} multi1[j-u][d-u] * multi2[j][u]
        const int i = blk * 32 + lane, d = i / kParts, part = i % kParts;
        T s = T(0);
        if (d < band) {
          const int u1 = min(min(W, d), j);
          int slot = m1slot - 1 - part;
          if (slot < 0) slot += W + 1;
#pragma unroll 4
          for (int u = 1 + part; u <= u1; u += kParts) {
            s += m1w[slot * band + d - u] * m2c[u];
            slot -= kParts;
            if (slot < 0) slot += W + 1;
          }
        }
        s = part_sum(s);
        if (part == 0 && d < band) mb[d] = s;
        continue;
      }
      if (blk < 2 * nspw) {
        // bulges: sum_{k=2..ML} stem_au[j][d-k] Kb[k] + Kb[0] stem_au[j][d]
        // + the window; gen: genw's chunks
        const int i = (blk - nspw) * 32 + lane, d = i / kParts,
                  part = i % kParts;
        T s1 = T(0), g = T(0);
        if (d < band) {
          const T *xa = saw + sl * xs + ml + d;
#pragma unroll 4
          for (int k = 2 + part; k <= ml; k += kParts) s1 += xa[-k] * Kb[k];
          const T *gwc = gw + (j & 1) * kChunks * band + d;
#pragma unroll
          for (int c = part; c < kChunks; c += kParts) g += gwc[c * band];
        }
        s1 = part_sum(s1);
        g = part_sum(g);
        if (part == 0 && d < band) {
          bul[d] = s1 + (Kb[0] * saw[sl * xs + ml + d] + bw[d]);
          gen[d] = g;
        }
        continue;
      }
      if (blk == 2 * nspw) {
        // the exterior step of column j-1: its stem is still in the ring,
        // its grid rows in their buffer
        if (j > 0)
          a_step(j - 1, ja == 0 ? band - 1 : ja - 1, st1,
                 gb + (gs == 0 ? 2 : gs - 1) * kGrids * band
                    + EXT_DOT * band);
        continue;
      }
      genw_chunk(j + 1, sl1, blk - 2 * nspw - 1);
    }
    // column j+1's grid rows, loaded during column j-1's stage 2: column j
    // reads the buffers of columns j-1, j and (in stage 2) j+1
    if (j + 1 < n1) {
      T *gn = gb + gs1 * kGrids * band;
      if (tid < band) {
#pragma unroll
        for (int i = 0; i < kGrids; ++i) gn[i * band + tid] = gnext[i];
      }
      for (int d = tid + nt; d < band; d += nt) {  // band > threads only
        load_cell(p, ((j + 1) * B + b) * band + d, gnext);
        for (int i = 0; i < kGrids; ++i) gn[i * band + d] = gnext[i];
      }
    }
    STAGE_END(0);

    // column j+2's grid rows, stored at the end of column j+1's stage 1
    if (tid < band && j + 2 < n1)
      load_cell(p, ((j + 2) * B + b) * band + tid, gnext);

    // ---- 2. multi, stemend, multi1, then column j+1's stems; column
    //      j+1's bulge window; genw ----
    for (int blk = warp; blk < 2 * nspw + kC; blk += nwarp) {
      if (blk < nspw) {
        const int i = blk * 32 + lane, d = i / kParts, part = i % kParts;
        T mlt = T(0);
        if (d < band)
#pragma unroll 4
          for (int e = part; e <= d; e += kParts) mlt += mb[e] * Lrow[d - e];
        mlt = part_sum(mlt);
        if (part != 0 || d >= band) continue;
        const int64_t o = row + d;
        T se = G_(HPW, d) + gen[d] * G_(MISM_OUT, d);
        se = se + bul[d] * G_(AU_OUT, d);
        se = se + G_(SP10, d) * (d >= 1 ? st[d - 1] : T(0));
        se = se + G_(SP01, d) * (d >= 1 ? st1[d - 1] : T(0));
        se = se + G_(SP11, d) * (d >= 2 ? st1[d - 2] : T(0));
        se = se + G_(SP21, d) * (d >= 3 ? st1[d - 3] : T(0));
        se = se + G_(SP12, d) * (d >= 3 ? st2[d - 3] : T(0));
        se = se + G_(SP22, d) * (d >= 4 ? st2[d - 4] : T(0));
        se = se + mlt * G_(MLCLOSE, d);
        se = G_(VALIDC, d) != T(0) ? se : T(0);    // stemend
        const T m1 = m2c[d] + mb[d];
        m1w[m1slot * band + d] = m1;
        p.multi[o] = mlt;
        p.multi1[o] = m1;
        // column j+1's stems at span d+2, from this span's stem and
        // stemend (spans 0 and 1, which have none, from the last two)
        if (j + 1 < n1) {
          const int t = d + 2 < band ? d + 2 : d + 2 - band;
          stem_cell(j + 1, gs1, sl1, t, t >= 2 ? st[d] : T(0),
                    t >= 2 ? se : T(0));
        }
        continue;
      }
      if (blk < 2 * nspw) {
        // column j+1's bulge window: sum_{u>=1} Kb[u] stem_au[j+1-u][d-u]
        const int i = (blk - nspw) * 32 + lane, d = i / kParts,
                  part = i % kParts;
        T s = T(0);
        if (d < band) {
          const int u1 = min(ml, j + 1);
          int slot = sl - part < 0 ? sl - part + R : sl - part;
          const T *x = saw + ml + d;
#pragma unroll 4
          for (int u = 1 + part; u <= u1; u += kParts) {
            s += Kb[u] * x[slot * xs - u];
            slot -= kParts;
            if (slot < 0) slot += R;
          }
        }
        s = part_sum(s);
        if (part == 0 && d < band) bw[d] = s;
        continue;
      }
      genw_chunk(j + 1, sl1, kB + blk - 2 * nspw);
    }
#undef G_
    STAGE_END(1);
    sl = sl1;
    gs = gs1;
    m1slot = m1slot == W ? 0 : m1slot + 1;
    ja = ja == band - 1 ? 0 : ja + 1;
  }

  // the last column's exterior step
  if (warp == 0)
    a_step((int)n1 - 1, ja == 0 ? band - 1 : ja - 1,
           stemr + ((n1 - 1) & 3) * band,
           gb + (gs == 0 ? 2 : gs - 1) * kGrids * band + EXT_DOT * band);
  __syncthreads();

  // ---- backward exterior scan (warp 0): B[i] = B[i+1] +
  // log1p(sum_dp stem[i+dp][dp] ext_dot[i+dp][dp] exp(B[i+dp] - B[i+1])),
  // B = 0 past the last column (awin, zeroed, now holds B[c] at c % band).
  // The products of kSteps steps at a time are staged in shared memory
  // (two buffers over the forward pass's windows) by the other warps while
  // warp 0 runs the steps before them. ----
  T *sbuf = sm + l.smw;
  auto load_steps = [=](int i0, T *buf, int w0, int nw) {
    // steps i = i0 .. i0-kSteps+1 (>= 0), term dp at buf[(i0-i)*band + dp],
    // by warps w0, w0 + nw, ...: a warp reads column c = i + dp's row,
    // contiguous in dp (0 past the last column)
    const int ilo = i0 - kSteps + 1 > 0 ? i0 - kSteps + 1 : 0;
    for (int c = ilo + 1 + w0; c <= i0 + band - 1; c += nw) {
      const int64_t o = ((int64_t)c * B + b) * band;
      for (int dp = 1 + lane; dp < band; dp += 32) {
        if (dp < c - i0 || dp > c - ilo) continue;
        const T v = c < n1 ? p.stem[o + dp] * p.ext_dot[o + dp] : T(0);
        buf[(i0 - c + dp) * band + dp] = v;
      }
    }
  };
  for (int k = tid; k < band; k += nt) awin[k] = T(0);
  load_steps((int)n1 - 1, sbuf, warp, nwarp);
  __syncthreads();
  T b_next = T(0);
  for (int i0 = (int)n1 - 1, ch = 0; i0 >= 0; i0 -= kSteps, ++ch) {
    const T *cur = sbuf + (ch & 1) * kSteps * band;
    if (warp == 0) {
      const int ilo = i0 - kSteps + 1 > 0 ? i0 - kSteps + 1 : 0;
      int ib = i0 % band;  // slot of B[i]
      for (int i = i0; i >= ilo; --i) {
        const T *rw = cur + (i0 - i) * band;
        T part = T(0);
        for (int dp = 1 + lane; dp < band; dp += 32) {
          const int c = ib + dp < band ? ib + dp : ib + dp - band;
          part += rw[dp] * ex(awin[c] - b_next);
        }
        part = warp_sum(part);
        const T bc = b_next + l1p(part);
        if (lane == 0) {
          awin[ib] = bc;
          p.Bx[(int64_t)i * B + b] = bc;
        }
        __syncwarp();
        b_next = bc;
        ib = ib == 0 ? band - 1 : ib - 1;
      }
    }
    if (i0 - kSteps >= 0 && (warp > 0 || nwarp == 1))
      load_steps(i0 - kSteps, sbuf + ((ch + 1) & 1) * kSteps * band,
                 nwarp == 1 ? 0 : warp - 1, nwarp == 1 ? 1 : nwarp - 1);
    __syncthreads();
  }
  STAGE_END(2);
#ifdef ACCESS_STAMPS
  stamps.finish(n1);
#endif
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
// sizes: N+1, B, band, ML, threads per block (a multiple of 32);
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
  // genw's chunks: kChunks equal runs of its (u2, r) pairs
  const int pairs = p.ml * (p.ml + 1) / 2;
  for (int c = 0, k = 0, u = 1, r = 1; c <= kChunks; ++c) {
    for (; k < (c * pairs + kChunks - 1) / kChunks; ++k)
      if (++r > p.ml) r = ++u;
    p.cu[c] = c < kChunks ? u : p.ml + 1;
    p.cr[c] = c < kChunks ? r : p.ml + 1;
  }
  const size_t bytes = (size_t)layout(p.band, p.ml).total * sizeof(T);
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (bytes > (size_t)max_smem || p.B > 0x7fffffff ||
      p.n1 > 0x7fffffff || p.band < 3 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidConfiguration;
  auto kern = inside_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<(int)p.B, threads, bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The CTAs of inside_kernel<T> that the card holds at once at `threads`
// per CTA and the shared memory of band `band`: its SMs times the CTAs an
// SM holds (0 where none fits); a CUDA error as its negative
template <typename T>
int slots(int band, int ml, int threads) {
  const size_t bytes = (size_t)layout(band, ml).total * sizeof(T);
  int dev = 0, sms = 0, per_sm = 0;
  auto kern = inside_kernel<T>;
  cudaError_t e = (cudaError_t)cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = (cudaError_t)cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      bytes);
  return e == cudaSuccess ? sms * per_sm : -(int)e;
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

// sizes: band, ML, threads per CTA; the CTAs of the kernel the current
// device holds at once (slots<T>)
extern "C" int access_inside_slots_f32(const long long *sizes) {
  return slots<float>((int)sizes[0], (int)sizes[1], (int)sizes[2]);
}

extern "C" int access_inside_slots_f64(const long long *sizes) {
  return slots<double>((int)sizes[0], (int)sizes[1], (int)sizes[2]);
}

#ifdef ACCESS_STAMPS
// The stage names, comma-separated, in the order of the sums.
extern "C" const char *access_inside_stage_names() {
  return "sums,stemend,backward";
}

// Copy the 2 * stages + 1 sums (work cycles per stage, barrier cycles per
// stage, columns) to `out` and clear them; synchronises the device.
extern "C" int access_inside_stamps(unsigned long long *out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[2 * kStages + 1] = {};
  return (int)cudaMemcpyToSymbol(g_stamps, zero, sizeof(g_stamps));
}
#endif
