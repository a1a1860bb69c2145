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
// Bound on this card: the bytes of the grids, multi1 and the planes, each
// read or written once, set the least time; the operations it needs (most
// of them the K2 triangle, u <= r) take less. The columns are a chain of
// dependent steps over B CTAs only, so the latency of one column step sets
// the time: the issue slots and dependent latencies of its 24 warps, not
// bytes. The design keeps that step short:
// - no device memory on a column's path: the 17 grid rows of column q-1
//   and the multi1 row that column q-1 first needs are loaded while column
//   q computes (registers, then shared memory at its end), and the inside
//   pass's multi1 rows q-W+1..q stay in a shared ring (slot = row mod
//   band; rows before 0 read as 0, as the plain version's front padding);
// - no span sum left to one thread: every sum over a span's terms is split
//   over kParts lanes (strided terms) and reduced with __shfl_xor_sync;
// - the window sums of column q (the K2 contraction's terms u >= 1, the
//   bulge window and bm1) read only columns q+1.. and are spread over the
//   three stages that precede their use; the contraction, two thirds of
//   the work, runs as warp tasks with no divergence and one K2 read for
//   three terms;
// - every loop has its trip count set before it starts, so that it
//   unrolls and its loads issue together.
//
// Per column q = N..0, three stages, each ended by a block barrier; warp w
// takes a stage's 32-lane blocks w, w + warps, ... (the contraction's
// chunks first, one block each; every other task's item count is padded
// to 32, so a warp never straddles two tasks):
//   A. bse (from the next column's b_stem at span d+2, masked to valid_int
//      and d < W), bse_mism, bse_au and the multiloop closing term clos;
//      bm1[d] = sum_t bmb[q+t][d+t] multi2[q+t][t]; the bulge window
//      sum_{u>=1} Kb[u] bse_au[q+u][d+u]; kA chunks of the window
//      contraction genw[d] = sum_{u>=1} sum_{r>=u} K2[r][u] bse_mism[q+u][d+r];
//   B. bmulti[d] = sum_{e>=d} clos[e] Lrow[e-d] (Lrow[k] = (W_mlb
//      sigma^-1)^k) and bmb = bm1 + bmulti into the b_multibif window; the
//      same column's terms u = 0 of the contraction and of the bulges; kB
//      chunks of genw;
//   C. b_multi2 (bm1, the next column's b_multi2 at span d+1, and the
//      same-column sum over f of bmb[q][d+f] multi1[q-d][f]), then b_stem
//      from gen, the bulges, the small-loop specials and the helix
//      continuation; kC chunks of column q-1's genw; the prefetched rows
//      into shared memory.
//
// Shared memory: the bse_mism window ((ML+1) rows, zero past the band)
// and the bse_au window ((ML+1) x band), rings over columns; the
// b_multibif window ((W+1) x band); the multi1 ring (band x (band+1)); two
// buffers of the 17 grid rows; the last three bse columns, b_stem and
// b_multi2 (two buffers each); clos, bm1, the u = 0 contraction, the
// bulge sums; genw's partial sums (two columns x kChunks x band); the
// tables K2, Kb and Lrow: ~97 KB in float, ~195 KB in double at band 72.
//
// C entry points (ctypes): access_outside_f32, access_outside_f64. They
// launch on the given stream and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

#ifdef ACCESS_STAMPS
// A build with -DACCESS_STAMPS (access_ab.py; never the wrapper's) stamps
// every block barrier of the column loop: per stage, the SM cycles from the
// previous barrier's exit (thread 0) to the last thread's arrival (work),
// and from that arrival to thread 0's exit (barrier), summed over every
// column of every CTA; access_outside_stamps reads and clears the sums.
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
#define STAGE_END(k) st.sync(k)
#else
#define STAGE_END(k) __syncthreads()
#endif

constexpr int kMaxThreads = 1024;  // launch bound: at most 64 registers
constexpr int kParts = 2;    // lanes per span of a split span sum
// genw's chunks (warp tasks): kC of them in stage C for the next column,
// then kA in stage A and kB in stage B (A also runs bm1 and the bulge
// window)
constexpr int kC = 11, kA = 5, kB = 8, kChunks = kC + kA + kB;

// the grid rows of a column, in shared memory in this order
constexpr int kGrids = 17;
enum { SEED, DANGLE, BSE_MW, BSE_AW, MISM_O2, AU_O2, CONTW, MLCLOSE, SPO10,
       SPO01, SPO11, SPO12, SPO21, SPO22, M2DIAG, T2NZ, VALID };

// offsets (in elements of T) of the shared-memory regions
struct Layout {
  int k2, kb, lrow, bsew, bsaw, bmbw, m1r, gb, bse, bst, bm2, clos, bm1,
      gen0, bul, gw, chunk, total;
};

// row stride of the bse_mism window: a warp's lanes run spans d, d+32,
// d+64 over every r <= ML, and the row is zero past the band
__host__ __device__ inline int xstride(int band, int ml) {
  return (band + 95) / 96 * 96 + ml;
}

__host__ __device__ inline Layout layout(int band, int ml) {
  const int R = ml + 1, W = band - 2;
  Layout l;
  int o = 0;
  l.k2 = o;   o += R * R;
  l.kb = o;   o += R;
  l.lrow = o; o += band;
  l.bsew = o; o += R * xstride(band, ml);
  l.bsaw = o; o += R * band;
  l.bmbw = o; o += (W + 1) * band;
  l.m1r = o;  o += band * (band + 1);
  l.gb = o;   o += 2 * kGrids * band;
  l.bse = o;  o += 3 * band;
  l.bst = o;  o += 2 * band;
  l.bm2 = o;  o += 2 * band;
  l.clos = o; o += band;
  l.bm1 = o;  o += band;
  l.gen0 = o; o += band;
  l.bul = o;  o += band;
  l.gw = o;   o += 2 * kChunks * band;
  l.chunk = o; o += 2 * (kChunks + 1);  // genw's chunk bounds, as int
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
  // genw's chunk c runs the (u, r) pairs, u = 1..ML, r = u..ML in that
  // order, from (cu[c], cr[c]) to (cu[c+1], cr[c+1]), exclusive
  int cu[kChunks + 1], cr[kChunks + 1];
  T sig2, decay, w_mli;
};

// the 17 grids of one cell, in the enum's order
template <typename T>
__device__ inline void load_cell(const Params<T> &p, int64_t o, T *v) {
  v[SEED] = p.seed[o];
  v[DANGLE] = p.dangle[o];
  v[BSE_MW] = p.bse_mism_w[o];
  v[BSE_AW] = p.bse_au_w[o];
  v[MISM_O2] = p.mism_out2[o];
  v[AU_O2] = p.au_out2[o];
  v[CONTW] = p.contW[o];
  v[MLCLOSE] = p.mlclose_o[o];
  v[SPO10] = p.spo10[o];
  v[SPO01] = p.spo01[o];
  v[SPO11] = p.spo11[o];
  v[SPO12] = p.spo12[o];
  v[SPO21] = p.spo21[o];
  v[SPO22] = p.spo22[o];
  v[M2DIAG] = p.m2diag[o];
  v[T2NZ] = p.t2_nz[o] ? T(1) : T(0);
  v[VALID] = p.valid_int[o] ? T(1) : T(0);
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

__device__ inline int wrap(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

template <typename T>
__global__ void
#ifndef ACCESS_STAMPS  // the stamps' registers would spill under the bound
__launch_bounds__(kMaxThreads)
#endif
    outside_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T *sm = reinterpret_cast<T *>(smem);
  const int band = p.band, ml = p.ml, R = ml + 1, W = band - 2;
  const int ms = band + 1;  // multi1 ring row stride (odd: fewer conflicts)
  const int xs = xstride(band, ml);
  const Layout l = layout(band, ml);
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5, nwarp = nt >> 5;
  const int64_t b = blockIdx.x, B = p.B, n1 = p.n1;

  for (int k = tid; k < l.total; k += nt) sm[k] = T(0);
  __syncthreads();
  const T *K2 = sm + l.k2, *Kb = sm + l.kb, *Lrow = sm + l.lrow;
  T *bsew = sm + l.bsew, *bsaw = sm + l.bsaw, *bmbw = sm + l.bmbw;
  T *m1r = sm + l.m1r, *gb = sm + l.gb;
  T *bser = sm + l.bse, *bst = sm + l.bst, *bm2r = sm + l.bm2;
  T *clos = sm + l.clos, *bm1 = sm + l.bm1, *gen0 = sm + l.gen0;
  T *bul = sm + l.bul, *gw = sm + l.gw;
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
  // multi1 rows n1-band+2 .. n1-1 (those >= 0), the rows column N-1 reads
  for (int k = tid; k < (band - 2) * band; k += nt) {
    const int r = (int)n1 - 1 - k / band;
    if (r >= 0)
      m1r[wrap(r, band) * ms + k % band] =
          p.multi1[((int64_t)r * B + b) * band + k % band];
  }
  for (int d = tid; d < band; d += nt) {
    T v[kGrids];
    load_cell(p, ((n1 - 1) * B + b) * band + d, v);
#pragma unroll
    for (int i = 0; i < kGrids; ++i)
      gb[((n1 - 1) & 1) * kGrids * band + i * band + d] = v[i];
  }
  __syncthreads();
#ifdef ACCESS_STAMPS
  __shared__ unsigned long long arrive[kStages];
  Stamps st;
  st.start(arrive);
#endif

  // genw's chunk c for column qc into its column's partial sums, by one
  // warp: a lane runs spans d, d+32 and d+64 (the K2 read is a broadcast
  // and serves three terms; the rows are zero past the band, so no lane
  // has a span bound and the warp never diverges). Every loop below has
  // its trip count set before it starts, so that it unrolls and its loads
  // issue together.
  auto genw_chunk = [=](int qc, int c) {
    const int u0 = cu[c], ue = cu[c + 1];
    const int u1 = min(min(ue, ml), (int)n1 - 1 - qc);
    T *out = gw + (qc & 1) * kChunks * band + c * band;
    for (int d = lane; d < band; d += 96) {
      T s0 = T(0), s1 = T(0), s2 = T(0);
      int slot = wrap(qc + u0, R);
      for (int u = u0; u <= u1; ++u) {
        const T *x = bsew + slot * xs + d, *k2 = K2 + u;
        const int r1 = u == ue ? cr[c + 1] : ml + 1;
#pragma unroll 4
        for (int r = u == u0 ? cr[c] : u; r < r1; ++r) {
          const T k = k2[r * R];
          s0 += k * x[r];
          s1 += k * x[r + 32];
          s2 += k * x[r + 64];
        }
        slot = slot == R - 1 ? 0 : slot + 1;
      }
      out[d] = s0;
      if (d + 32 < band) out[d + 32] = s1;
      if (d + 64 < band) out[d + 64] = s2;
    }
  };
  const int nsp = pad32(kParts * band), nspw = nsp / 32;

  for (int q = (int)n1 - 1; q >= 0; --q) {
    const int64_t row = (q * B + b) * band;
    T *bs0 = bser + (q % 3) * band;               // bse, column q
    const T *bs1 = bser + ((q + 1) % 3) * band;   // column q+1 (0 past N)
    const T *bs2 = bser + ((q + 2) % 3) * band;   // column q+2
    T *bstc = bst + (q & 1) * band;               // b_stem, column q
    const T *bstn = bst + ((q + 1) & 1) * band;   // column q+1
    T *bm2c = bm2r + (q & 1) * band;
    const T *bm2n = bm2r + ((q + 1) & 1) * band;
    const int sl = q % R;                         // window slot of column q
    const int bmslot = q % (W + 1);               // b_multibif slot
    const int last = (int)n1 - 1 - q;             // columns after q
    const T *gc = gb + (q & 1) * kGrids * band;   // grid rows of column q
#define G(i, d) gc[(i) * band + (d)]

    // column q-1's grid rows and the multi1 row q-band+2 (first read at
    // column q-1), loaded now and stored at the end of stage C
    const int mrow = q - band + 2;
    T gnext[kGrids], m1next = T(0);
    if (tid < band && q > 0) {
      load_cell(p, ((q - 1) * B + b) * band + tid, gnext);
      if (mrow >= 0) m1next = p.multi1[((int64_t)mrow * B + b) * band + tid];
    }

    // ---- A. bse, bse_mism, bse_au, clos; bm1; bulge window; genw ----
    for (int blk = warp; blk < kA + 2 * nspw + pad32(band) / 32;
         blk += nwarp) {
      if (blk < kA) {
        genw_chunk(q, kC + blk);
        continue;
      }
      int it = (blk - kA) * 32 + lane;
      if (it - lane < nsp) {
        // bm1[d] = sum_{t=1..W} bmb[q+t][d+t] * multi2[q+t][t]
        const int d = it / kParts, part = it % kParts;
        T s = T(0);
        if (d < band && G(VALID, d) != T(0)) {
          int slot = wrap(q + 1 + part, W + 1);
          const int t1 = min(min(W, band - 1 - d), last);
#pragma unroll 4
          for (int t = 1 + part; t <= t1; t += kParts) {
            s += bmbw[slot * band + d + t] * G(M2DIAG, t);
            slot += kParts;
            if (slot > W) slot -= W + 1;
          }
        }
        s = part_sum(s);
        if (part == 0 && d < band) bm1[d] = s;
        continue;
      }
      it -= nsp;
      if (it - lane < nsp) {
        // the bulge window: sum_{u>=1} Kb[u] bse_au[q+u][d+u]
        const int d = it / kParts, part = it % kParts;
        T s = T(0);
        if (d < band) {
          int slot = wrap(q + 1 + part, R);
          const int u1 = min(min(ml, band - 1 - d), last);
#pragma unroll 4
          for (int u = 1 + part; u <= u1; u += kParts) {
            s += Kb[u] * bsaw[slot * band + d + u];
            slot += kParts;
            if (slot >= R) slot -= R;
          }
        }
        s = part_sum(s);
        if (part == 0 && d < band) bul[d] = s;
        continue;
      }
      it -= nsp;
      const int d = it;
      if (d >= band) continue;
      const int64_t o = row + d;
      const bool vi = G(VALID, d) != T(0);
      const T nx = d + 2 < band ? bstn[d + 2] : T(0);
      const T s = (vi && d < W) ? nx * p.sig2 : T(0);
      const T sm_ = s * G(BSE_MW, d);
      const T sa = s * G(BSE_AW, d);
      bs0[d] = s;
      bsew[sl * xs + d] = sm_;
      bsaw[sl * band + d] = sa;
      clos[d] = vi ? s * G(MLCLOSE, d) : T(0);
      p.bse[o] = s;
      p.bse_m[o] = sm_;
      p.bse_a[o] = sa;
    }
    STAGE_END(0);

    // ---- B. bmulti and bmb; the same column's contraction and bulges;
    //      genw ----
    for (int blk = warp; blk < kB + 2 * nspw; blk += nwarp) {
      if (blk < kB) {
        genw_chunk(q, kC + kA + blk);
        continue;
      }
      const int it = (blk - kB) * 32 + lane;
      const int d = it % nsp / kParts, part = it % kParts;
      if (it - lane < nsp) {
        T s = T(0);
        if (d < band && G(VALID, d) != T(0))
#pragma unroll 4
          for (int e = d + part; e < band; e += kParts)
            s += clos[e] * Lrow[e - d];
        s = part_sum(s);
        if (part == 0 && d < band) {
          const T bmb = (bm1[d] + s) * (d < band - 1 ? T(1) : T(0));
          bmbw[bmslot * band + d] = bmb;
          p.bmulti[row + d] = s;
        }
        continue;
      }
      // u = 0: sum_r K2[r][0] bse_mism[q][d+r] and the bulges
      // sum_{k>=2} bse_au[q][d+k] Kb[k] + Kb[0] bse_au[q][d]
      const T *xm = bsew + sl * xs, *xa = bsaw + sl * band;
      T g = T(0), s1 = T(0);
      if (d < band) {
        const int r1 = min(ml, band - 1 - d);
#pragma unroll 4
        for (int r = part; r <= r1; r += kParts) g += K2[r * R] * xm[d + r];
#pragma unroll 4
        for (int k = 2 + part; k <= r1; k += kParts) s1 += xa[d + k] * Kb[k];
      }
      g = part_sum(g);
      s1 = part_sum(s1);
      if (part == 0 && d < band) {
        gen0[d] = g;
        bul[d] = s1 + (Kb[0] * xa[d] + bul[d]);
      }
    }
    STAGE_END(1);

    // ---- C. b_multi2, b_stem; genw of column q-1 ----
    for (int blk = warp; blk < kC + nspw; blk += nwarp) {
      if (blk < kC) {
        if (q > 0) genw_chunk(q - 1, blk);
        continue;
      }
      const int it = (blk - kC) * 32 + lane;
      const int d = it / kParts, part = it % kParts;
      // same-column bifurcations: e = d + f <= W (bmb is 0 at band-1)
      T s = T(0);
      if (d < band) {
        const T *m1 = m1r + wrap(q - d, band) * ms;
        const T *bmb = bmbw + bmslot * band + d;
#pragma unroll 4
        for (int f = 1 + part; f <= W - d; f += kParts) s += bmb[f] * m1[f];
      }
      s = part_sum(s);
      if (part != 0 || d >= band) continue;
      const int64_t o = row + d;
      T b2 = bm1[d] + (d + 1 < band ? bm2n[d + 1] : T(0)) * p.decay;
      b2 = b2 + s;
      b2 = G(VALID, d) != T(0) ? b2 : T(0);

      T gen = gen0[d];
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        gen += gw[(q & 1) * kChunks * band + c * band + d];
      T out = G(SEED, d) * G(DANGLE, d);
      out = out + gen * G(MISM_O2, d);
      out = out + bul[d] * G(AU_O2, d);
      out = out + G(SPO10, d) * (d + 1 < band ? bs0[d + 1] : T(0));
      out = out + G(SPO01, d) * (d + 1 < band ? bs1[d + 1] : T(0));
      out = out + G(SPO11, d) * (d + 2 < band ? bs1[d + 2] : T(0));
      out = out + G(SPO21, d) * (d + 3 < band ? bs1[d + 3] : T(0));
      out = out + G(SPO12, d) * (d + 3 < band ? bs2[d + 3] : T(0));
      out = out + G(SPO22, d) * (d + 4 < band ? bs2[d + 4] : T(0));
      out = out + (d + 2 < band ? bstn[d + 2] : T(0)) * G(CONTW, d);
      out = out + b2 * p.w_mli * G(DANGLE, d);
      bstc[d] = G(T2NZ, d) != T(0) ? out : T(0);
      bm2c[d] = b2;
      p.bm2[o] = b2;
    }
#undef G
    // the prefetched rows: column q reads neither the grid buffer of
    // column q-1 nor the ring slot of row q-band+2
    if (q > 0) {
      T *gn = gb + ((q - 1) & 1) * kGrids * band;
      if (tid < band) {
#pragma unroll
        for (int i = 0; i < kGrids; ++i) gn[i * band + tid] = gnext[i];
        m1r[wrap(mrow, band) * ms + tid] = m1next;
      }
      for (int d = tid + nt; d < band; d += nt) {  // band > threads only
        load_cell(p, ((q - 1) * B + b) * band + d, gnext);
        for (int i = 0; i < kGrids; ++i) gn[i * band + d] = gnext[i];
        m1r[wrap(mrow, band) * ms + d] =
            mrow >= 0 ? p.multi1[((int64_t)mrow * B + b) * band + d] : T(0);
      }
    }
    STAGE_END(2);
  }
#ifdef ACCESS_STAMPS
  st.finish(n1);
#endif
}

// ptrs: the 17 grids in batched.py:OutsideGrids order (t2_nz, seed,
//   dangle_pq, bse_mism_w, bse_au_w, mism_out2, au_out2, contW, mlclose_o,
//   spo10, spo01, spo11, spo12, spo21, spo22, m2diag, valid_int), multi1,
//   K2, Kb, Lrow, bse, bse_m, bse_a, b_multi, b_multi2 (26 device pointers);
// sizes: N+1, B, band, ML, threads per block (a multiple of 32);
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
  // genw's chunks: kChunks equal runs of its (u, r) pairs
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
  auto kern = outside_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<(int)p.B, threads, bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The CTAs of outside_kernel<T> that the card holds at once at `threads`
// per CTA and the shared memory of band `band`: its SMs times the CTAs an
// SM holds (0 where none fits); a CUDA error as its negative
template <typename T>
int slots(int band, int ml, int threads) {
  const size_t bytes = (size_t)layout(band, ml).total * sizeof(T);
  int dev = 0, sms = 0, per_sm = 0;
  auto kern = outside_kernel<T>;
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

extern "C" int access_outside_f32(void *const *ptrs, const long long *sizes,
                                  const double *scalars, void *stream) {
  return launch<float>(ptrs, sizes, scalars, stream);
}

extern "C" int access_outside_f64(void *const *ptrs, const long long *sizes,
                                  const double *scalars, void *stream) {
  return launch<double>(ptrs, sizes, scalars, stream);
}

// sizes: band, ML, threads per CTA; the CTAs of the kernel the current
// device holds at once (slots<T>)
extern "C" int access_outside_slots_f32(const long long *sizes) {
  return slots<float>((int)sizes[0], (int)sizes[1], (int)sizes[2]);
}

extern "C" int access_outside_slots_f64(const long long *sizes) {
  return slots<double>((int)sizes[0], (int)sizes[1], (int)sizes[2]);
}

#ifdef ACCESS_STAMPS
// The stage names, comma-separated, in the order of the sums.
extern "C" const char *access_outside_stage_names() { return "A,B,C"; }

// Copy the 2 * stages + 1 sums (work cycles per stage, barrier cycles per
// stage, columns) to `out` and clear them; synchronises the device.
extern "C" int access_outside_stamps(unsigned long long *out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[2 * kStages + 1] = {};
  return (int)cudaMemcpyToSymbol(g_stamps, zero, sizeof(g_stamps));
}
#endif
