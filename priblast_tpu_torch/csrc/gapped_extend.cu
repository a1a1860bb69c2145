// One direction of the gapped extension for Hopper (sm_90a): from the
// characters to the traceback, per hit, in one kernel.
//
// Replaces the TPU Pallas kernel _sweep_kernel
// (priblast_tpu/search/gapped_pl.py:51) together with the XLA preamble and
// epilogue around it (priblast_tpu/search/gapped.py:_extend_dir). Reference
// semantics: src/gapped_extension.cpp:88-319 and 409-424. The arithmetic
// follows the plain PyTorch version in ops/gapped_sweep.py
// (extend_dir_plain: energy planes, sweep_plain, traceback) operation for
// operation, so both give the same bits; build with -fmad=false so that no
// multiply-add is contracted, and every /100 is a true division.
//
// Per hit, in the order of the plain version:
//   1. character windows qm/dm[x], x < XW, at start + sign*x of the flat
//      buffers (0 outside the buffer), with the GetChar mapping;
//   2. maxq/maxd: the offset before the first blocked character at x >= 1;
//   3. the prefix chains extq/extdb, one add at a time (for double, the
//      x = 1 increment is computed in float and widened);
//   4. the origin cell at diagonal 0;
//   5. the banded anti-diagonal sweep L = 1..max_ext. Every energy of a
//      cell (i, j = L - i) is looked up from the characters around it in
//      the Turner tables (no energy planes); the combo minimum runs over the
//      (u1, u2) offsets in the reference's stems order with strict < (the
//      first minimum wins);
//   6. the traceback walk over the predecessor rows, which live in shared
//      memory as int16 (a packed value has 14 bits).
//
// Mapping: one warp per hit; several warps per block, persistent blocks
// that stride over the hits. The block loads int21, int11, the small tables
// (20 KB) and the loop constants into shared memory once, with the pair
// type t0 of each pair of characters; int22 (80 KB)
// is read from device memory through the L1 cache (in shared memory it
// leaves room for fewer warps per SM, and measured slower). The launch takes
// the warps per block that put the most warps in flight per SM.
// Each warp works on its own region of shared memory (rings of the last
// dropout + 2 diagonals: hyb, VM as int8, flag bits with the cell's stored
// pair type and a mask of the cells that hold a finite hyb; the two rows
// of helix-admission bits; the predecessor rows; the character windows and
// prefix chains; the work list's cell slots and entries) and syncs with
// __syncwarp only. On diagonal L only the band cells max(1, L - maxd) <= i
// <= min(L - 1, maxq) are worked on (~8 on the main path). Cells that are
// not admitted do no combo work, and a combo whose predecessor lies outside
// the band or holds INF is skipped (INF + x < run_min is never true, so
// this changes no bit). max_ext is at most 32 (kWorkMax; launch rejects
// more), so lane i is cell i and a ring row's finite cells fit one mask
// word. The sweep is a work list: the admitted cells put t0 and MS into
// slots in shared memory; then lane s takes loop size s, and for each
// admitted cell in turn the set bits of (ring row of diagonal L - s - 2) &
// (the cell's window of predecessors) are its combos (s, k): the lanes'
// counts, added up bit by bit with ballots, give each (cell, s) run its
// place in the diagonal's list (cell-major), which is dealt out over the 32
// lanes in rounds of 32 (a list of 32 entries, run whenever it fills).
// Every combo's energy is d100(integer) + ph, so the classes differ only in
// the integer they add: a bulge's terminal-AU terms, a special (u1, u2 <=
// 2) combo's table entry from the cell's characters and the predecessor's
// stored type, an interior loop's MS + VM. A segmented warp minimum on (Et,
// stems order) per round, pulled by the cell's lane, keeps the first
// minimum.
// The winning combo's payload is derived once, after the minimum. The
// template parameter DROP = 16, the main path's dropout (DROP = 0 is the
// generic path), makes the ring length a compile-time constant. Every loop
// energy of s <= 30 is an integer sum (exact in float and double), so
// x / 100 is looked up in a table of the quotients the division gives
// (built on the host in the working dtype); other values divide. The
// wrapper builds with -maxrregcount=64: the warps in flight this allows
// outweigh the spills. On the main path (float32, max_ext 32) registers and
// shared memory both allow 32 warps per SM.
//
// A build with -DGAPPED_STAMPS (gapped_ab.py; never the wrapper's) counts
// the work list's work (band, admitted cells, combos, rounds, ...) and
// lane 0's SM cycles by part, summed over the launch's hits;
// gapped_extend_stamps reads and clears the sums.
//
// Bound on this card: per hit the kernel reads a few hundred bytes
// (character and accessibility windows, the hit's columns) and writes its
// results and traceback lists; the combo minimum (~4 operations per
// reachable combo) is the work. The loop over the diagonals is sequential
// in each hit, so the kernel depends on many warps in flight to hide the
// latency of each step.
//
// Packed table buffer (one int16 buffer per device, built by
// ops/gapped_sweep.py:pack_tables; offsets in int16 words):
//   [kI22, +40000)  int22_37[8][8][5][5][5][5]
//   [kI21, +8000)   int21_37[8][8][5][5][5]
//   [kI11, +1600)   int11_37[8][8][5][5]
//   [kSmall, ...)   int32 words (offsets in int32 words from kSmall):
//                   kStack stack37[7][7], kMism mismatchI37[7][5][5],
//                   kBp BP_pair[5][5], kRtype rtype[7], kB1 bulge37[1],
//                   kTau TerminalAU
//   padded to kWords int16 words (a multiple of 8).
// With t0(a, b) = flag ? rtype[bp[a*5+b]] : bp[a*5+b] the pair type of
// the flag, st(a, b) = rtype[t0(a, b)] and, for cell (i, j),
// T = t0(q0, d0), qk = qm[i+k], dk = dm[j+k] (0 where i+k or j+k < 0):
//   stk(pt) = flag ? stack[pt*7+T] : stack[T*7+pt]
//   MS   = flag ? mism[(T*5+d-1)*5+q-1] : mism[(T*5+q-1)*5+d-1]
//   VM   = flag ? mism[(S*5+q1)*5+d1] : mism[(S*5+d1)*5+q1], S = st(q0, d0)
//   STK00 = stk(st(q-1, d-1)); STK10 = b1 + stk(st(q-2, d-1));
//   STK01 = b1 + stk(st(q-1, d-2))
//   V11  = i11[((A*8+C)*5+q-1)*5+d-1], (A, C) = flag ? (tb, T) : (T, tb),
//          tb = st(q-2, d-2)
//   V12  = flag ? i21[(((tb*8+T)*5+q-1)*5+d-1)*5+d-2]
//               : i21[(((T*8+tb)*5+q-1)*5+d-2)*5+d-1], tb = st(q-2, d-3)
//   V21  = flag ? i21[(((T*8+tb)*5+d-1)*5+q-2)*5+q-1]
//               : i21[(((tb*8+T)*5+d-1)*5+q-1)*5+q-2], tb = st(q-3, d-2)
//   V22  = flag ? i22[((((tb*8+T)*5+q-2)*5+q-1)*5+d-1)*5+d-2]
//               : i22[((((T*8+tb)*5+q-1)*5+q-2)*5+d-2)*5+d-1],
//          tb = st(q-3, d-3)
//   helix badness = (t0(q1, d1) == 0) | (wob(T) & wob(t0(q1, d1)))
//                   | OR over 2 <= k < min_helix of (t0(qk, dk) == 0)
// (tests/test_torch_tables.py mirrors these formulas in Python and holds
// them against every entry of search/gapped.py:_plane_tables.)
//
// C entry points (ctypes): gapped_extend_f32 / gapped_extend_f64. They
// launch on the given stream and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kI22 = 0, kI21 = 40000, kI11 = 48000, kSmall = 49600;
constexpr int kStack = 0, kMism = 49, kBp = 224, kRtype = 249, kB1 = 256,
              kTau = 257, kNSmall = 258;
constexpr int kWords = 50120;  // kSmall + 2 * kNSmall, padded to 8
static_assert(kSmall + 2 * kNSmall <= kWords && kWords % 8 == 0, "layout");
static_assert(kI21 % 8 == 0, "i22 must end on a 16-byte boundary");

constexpr int kBig = 10000000;  // "unbounded" boundary (MAX_EXTENSION)
constexpr unsigned kFull = 0xffffffffu;
// ring flag bits of a cell: admitted, pair type 0, wobble, terminal AU;
// above kSt its stored pair type rt[t0] (0..6)
constexpr int kAdm = 1, kZ = 2, kWb = 4, kAU = 8, kSt = 4;

template <typename T>
__device__ __forceinline__ T inf_of();
template <>
__device__ __forceinline__ float inf_of<float>() {
  return __int_as_float(0x7f800000);
}
template <>
__device__ __forceinline__ double inf_of<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

__host__ __device__ __forceinline__ int align16(int n) {
  return (n + 15) & ~15;
}

// the largest max_ext: a diagonal's cells fit the lanes and a ring row's
// finite cells one mask word
constexpr int kWorkMax = 32;
constexpr int kList = 32;   // work-list entries held at once (one round)
constexpr int kPairBytes = 112;  // the block's t0 of 25 pairs

// byte offsets of one warp's region of shared memory
struct WarpLayout {
  int ring_h, extq, extdb, ring_vm, pred, tbs, rmask, ring_f, mt, qm, dm,
      cell, list, total;
};

__host__ __device__ inline WarpLayout warp_layout(int W, int XW, int RH,
                                                  int steps, int tsize) {
  WarpLayout l;
  int off = 0;
  l.ring_h = off;  off += align16(RH * W * tsize);
  l.extq = off;    off += align16(XW * tsize);
  l.extdb = off;   off += align16(XW * tsize);
  l.ring_vm = off; off += align16(RH * W);
  l.pred = off;    off += align16((W + 1) * W * 2);
  l.tbs = off;     off += align16(2 * steps * 4);
  l.rmask = off;   off += align16(RH * 4);
  l.ring_f = off;  off += align16(RH * W);
  l.mt = off;      off += align16(2 * W);
  l.qm = off;      off += align16(XW);
  l.dm = off;      off += align16(XW);
  // the work list's cell slots (one a lane, lane i is cell i < W) and
  // entries
  l.cell = off;    off += align16(W * 4);
  l.list = off;    off += align16(kList * 4);
  l.total = off;
  return l;
}

template <typename T>
struct Params {
  const int64_t *q_enc, *db_seq;
  const float *q_acc, *q_cond, *db_acc, *db_cond;
  const int64_t *q_start, *db_start, *id_anchor, *qb, *qab, *dbb, *aoff,
      *coff;
  const T *energy0, *acc0;
  const uint8_t *valid;
  const int16_t *tables;
  // [2][dropout + 1] interior-loop and bulge constants, then
  // div[r - rlo] = T(r) / T(100) for the integers rlo <= r < rlo + nspan
  const T *consts;
  int32_t *ints;    // [B][5]: min_i, min_j, min_len, overflow, diagonals
  T *floats;        // [B][2]: min_e, min_a
  int32_t *tb;      // [B][2][steps]: tb_i, tb_j
  int64_t n_qenc, n_db, n_qacc, n_qcond, n_dacc, n_dcond, B;
  int flag, d, dropout, min_helix, max_ext, XW, steps, rlo, nspan;
};

__device__ __forceinline__ int64_t clampi(int64_t x, int64_t n) {
  return x < 0 ? 0 : (x > n - 1 ? n - 1 : x);
}

__device__ __forceinline__ int map_char(int64_t raw) {
  return raw < 2 ? 0 : (raw <= 5 ? (int)raw - 1 : (int)raw - 5);
}

__device__ __forceinline__ bool wob(int t) { return t == 3 || t == 4; }

template <typename T>
__device__ __forceinline__ void min_pair(T &v, int &k, T ov, int ok) {
  if (ov < v || (ov == v && ok < k)) {
    v = ov;
    k = ok;
  }
}

#ifdef GAPPED_STAMPS
// the instrumented build's sums over a launch's hits:
// counts, then lane 0's SM cycles by part
enum {
  kSHits, kSDiags, kSBand, kSAdm, kSCombos, kSSteps, kSEmpty, kSBusiest,
  kSRounds, kSNopred, kSCycHit, kSCycPre, kSCycAdmit, kSCycCombo, kSCycFallback,
  kSCycRest, kSCycPost, kNStamps
};
__device__ unsigned long long g_stamps[kNStamps];
#define STAMP(...) __VA_ARGS__
#else
#define STAMP(...)
#endif

template <typename T, int DROP>
__global__ void extend_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int W = p.max_ext, ME1 = W + 1, XW = p.XW, steps = p.steps;
  const int dropout = DROP > 0 ? DROP : p.dropout;
  const int RH = dropout + 2;
  const int flag = p.flag;
  const int tab_bytes = align16((kWords - kI21) * 2);
  const int n_cst = 2 * (dropout + 1) + p.nspan;
  const int cst_bytes = align16(n_cst * (int)sizeof(T));

  // ---- block: the tables after int22 (and the loop constants) into
  // shared memory, once
  {
    const int4 *src = reinterpret_cast<const int4 *>(p.tables + kI21);
    int4 *dst = reinterpret_cast<int4 *>(smem);
    for (int k = threadIdx.x; k < (kWords - kI21) / 8; k += blockDim.x)
      dst[k] = src[k];
    T *cst = reinterpret_cast<T *>(smem + tab_bytes);
    for (int k = threadIdx.x; k < n_cst; k += blockDim.x)
      cst[k] = p.consts[k];
  }
  __syncthreads();
  // the pair type t0 of the flag of each pair of characters (a * 5 + b),
  // after the loop constants
  int32_t *t0tab = reinterpret_cast<int32_t *>(smem + tab_bytes + cst_bytes);
  if (threadIdx.x < 25) {
    const int32_t *sm0 = reinterpret_cast<const int32_t *>(
        reinterpret_cast<const int16_t *>(smem) + (kSmall - kI21));
    const int t = sm0[kBp + threadIdx.x];
    t0tab[threadIdx.x] = flag ? sm0[kRtype + t] : t;
  }
  __syncthreads();
  const int16_t *tab = reinterpret_cast<const int16_t *>(smem);
  const int16_t *i22 = p.tables + kI22;
  const int16_t *i21 = tab;
  const int16_t *i11 = tab + (kI11 - kI21);
  const int32_t *sm = reinterpret_cast<const int32_t *>(tab + (kSmall - kI21));
  const int32_t *stack = sm + kStack, *mism = sm + kMism, *bp = sm + kBp,
                *rt = sm + kRtype;
  const T *cint = reinterpret_cast<const T *>(smem + tab_bytes);
  const T *cbul = cint + dropout + 1;
  const T *divt = cbul + dropout + 1;
  const int rlo = p.rlo, nspan = p.nspan;
  const int tau_i = sm[kTau];
  const int b1 = sm[kB1];
  const T INF = inf_of<T>();
  const T hundred = T(100);
  // x / 100 of an integer x: the division, looked up (the loop energies
  // of s <= 30 are integer sums, exact in T; the table holds the quotient
  // the division gives)
  auto d100 = [&](int r) -> T {
    const unsigned o = (unsigned)(r - rlo);
    return o < (unsigned)nspan ? divt[o] : T(r) / hundred;
  };
  auto cint_i = [&](int s) { return (int)cint[s]; };
  auto cbul_i = [&](int s) { return (int)cbul[s]; };

  // ---- this warp's region
  const WarpLayout wl = warp_layout(W, XW, RH, steps, (int)sizeof(T));
  unsigned char *wb =
      smem + tab_bytes + cst_bytes + kPairBytes + warp * wl.total;
  T *ring_h = reinterpret_cast<T *>(wb + wl.ring_h);
  T *extq = reinterpret_cast<T *>(wb + wl.extq);
  T *extdb = reinterpret_cast<T *>(wb + wl.extdb);
  int8_t *ring_vm = reinterpret_cast<int8_t *>(wb + wl.ring_vm);
  int16_t *pred = reinterpret_cast<int16_t *>(wb + wl.pred);
  int32_t *tbs = reinterpret_cast<int32_t *>(wb + wl.tbs);
  // per ring row, bit k: lane k holds a finite hyb
  uint32_t *rmask = reinterpret_cast<uint32_t *>(wb + wl.rmask);
  uint8_t *ring_f = wb + wl.ring_f;
  uint8_t *mt = wb + wl.mt;  // [2][W]: bit 0 type-0 bit, bit 1 wobble bit
  uint8_t *qm = wb + wl.qm;
  uint8_t *dm = wb + wl.dm;
  // the work list's cell slots, by lane (cell i): (t0 << 16) | (MS &
  // 0xffff); and its entries, (ring row << 15) | (s << 10) | (k << 5) | cell
  int32_t *cell = reinterpret_cast<int32_t *>(wb + wl.cell);
  uint32_t *list = reinterpret_cast<uint32_t *>(wb + wl.list);

  auto t0_of = [&](int a, int b) { return t0tab[a * 5 + b]; };
  auto vm_of = [&](int t, int q1, int d1) {
    const int s = rt[t];
    return flag ? mism[(s * 5 + q1) * 5 + d1] : mism[(s * 5 + d1) * 5 + q1];
  };
  const int sgn = flag ? 1 : -1;
  STAMP(long long n_hits = 0, n_diags = 0, n_band = 0, n_adm = 0,
        n_combos = 0, n_steps = 0, n_empty = 0, n_busiest = 0,
        n_rounds = 0, n_nopred = 0, cyc_hit = 0, cyc_pre = 0, cyc_admit = 0,
        cyc_combo = 0, cyc_fallback = 0, cyc_rest = 0, cyc_post = 0;)

  for (int64_t b = (int64_t)blockIdx.x * nwarps + warp; b < p.B;
       b += (int64_t)gridDim.x * nwarps) {
    STAMP(const long long t_hit = clock64();)
    // ---- 1-2. character windows, maxq / maxd ---------------------------
    const int64_t q0 = p.qb[b] + p.q_start[b];
    const int64_t d0 = p.dbb[b] + p.db_start[b];
    int maxq = kBig, maxd = kBig;
    for (int x0 = 0; x0 < XW; x0 += 32) {
      const int x = x0 + lane;
      int64_t rq = 0, rd = 0;
      if (x < XW) {
        const int64_t pq = q0 + sgn * x, pd = d0 + sgn * x;
        rq = (pq < 0 || pq >= p.n_qenc) ? 0 : p.q_enc[pq];
        rd = (pd < 0 || pd >= p.n_db) ? 0 : p.db_seq[pd];
        qm[x] = (uint8_t)map_char(rq);
        dm[x] = (uint8_t)map_char(rd);
      }
      const unsigned bq = __ballot_sync(kFull, x >= 1 && x < XW && rq < 2);
      const unsigned bd = __ballot_sync(kFull, x >= 1 && x < XW && rd < 2);
      if (maxq == kBig && bq) maxq = x0 + __ffs(bq) - 2;
      if (maxd == kBig && bd) maxd = x0 + __ffs(bd) - 2;
    }

    // ---- 3. prefix chains: increments in parallel, sums one at a time ---
    {
      const int64_t qa = p.qab[b] + p.q_start[b];
      const int64_t ida = p.id_anchor[b];
      const int64_t ca = p.coff[b] + ida, aa = p.aoff[b] + ida;
      for (int x = lane; x < XW; x += 32) {
        T iq, idb;
        if (flag == 0) {
          const int64_t pq = qa - x;
          const float a = p.q_acc[clampi(pq, p.n_qacc)];
          const float c = p.q_acc[clampi(pq + 1, p.n_qacc)];
          const float e = p.q_cond[clampi(pq + p.d, p.n_qcond)];
          iq = x == 1 ? T((a - c) + e) : (T(a) - T(c)) + T(e);
          idb = T(p.db_cond[clampi(ca + x, p.n_dcond)]);
        } else {
          iq = T(p.q_cond[clampi(qa + x, p.n_qcond)]);
          const int64_t pd = aa - x;
          const float a = p.db_acc[clampi(pd, p.n_dacc)];
          const float c = p.db_acc[clampi(pd + 1, p.n_dacc)];
          const float e = p.db_cond[clampi(ca - x + p.d, p.n_dcond)];
          idb = x == 1 ? T((a - c) + e) : (T(a) - T(c)) + T(e);
        }
        extq[x] = iq;
        extdb[x] = idb;
      }
      __syncwarp();
      if (lane < 2) {
        T *e = lane == 0 ? extq : extdb;
        T c = T(0);
        e[0] = T(0);
        for (int x = 1; x < XW; ++x) {
          c = c + e[x];
          e[x] = c;
        }
      }
    }

    // ---- 4. origin cell; rings empty below diagonal 0 -------------------
    const bool valid = p.valid[b] != 0;
    const T e0 = p.energy0[b], a0 = p.acc0[b];
    for (int k = lane; k < RH * W; k += 32) {
      ring_h[k] = INF;
      ring_f[k] = 0;
    }
    for (int k = lane; k < RH; k += 32) rmask[k] = 0;
    {
      int ot = bp[qm[0] * 5 + dm[0]];
      if (flag == 0) ot = rt[ot];
      const int obits = (ot == 0 ? 1 : 0) | (wob(ot) ? 2 : 0);
      for (int k = lane; k < W; k += 32) {
        mt[k] = k == 0 ? (uint8_t)obits : 1;  // diagonal 0 (row 0)
        mt[W + k] = 1;                        // diagonal -1 (row 1)
      }
    }
    __syncwarp();
    if (lane == 0) {
      const int to = t0_of(qm[0], dm[0]);
      ring_h[0] = valid ? e0 : INF;
      rmask[0] = ring_h[0] < INF ? 1u : 0u;
      ring_f[0] = (valid ? kAdm : 0) | (to == 0 ? kZ : 0) |
                  (wob(to) ? kWb : 0) | (to > 2 ? kAU : 0) | (rt[to] << kSt);
      ring_vm[0] = (int8_t)vm_of(to, qm[1], dm[1]);
    }
    __syncwarp();

    // ---- 5. the sweep -----------------------------------------------------
    STAMP(cyc_pre += clock64() - t_hit;)
    bool active = valid, ovf = false;
    T min_e = e0, min_a = a0;
    int min_i = 0, min_j = 0, min_len = 0, n_diag = 0;

    // the stems[0] fallback bits: the first admitted cell of the window in
    // (diagonal, lane) order
    auto stem0 = [&](int L) {
      int stem = 1;  // none admitted: type-0 bit set, wobble bit clear
      bool found = false;
      for (int r = 0; r < RH && !found; ++r) {
        const int D = L - RH + r;
        if (D < 0) continue;
        const uint8_t *rf = ring_f + (D % RH) * W;
        const unsigned m = __ballot_sync(kFull, lane < W && (rf[lane] & kAdm));
        if (m) {
          const int f = rf[__ffs(m) - 1];
          stem = ((f & kZ) ? 1 : 0) | ((f & kWb) ? 2 : 0);
          found = true;
        }
      }
      return stem;
    };

    // the running minimum of extq + extdb + hyb over the diagonal, from each
    // lane's (v, arg), then the stop test; `any`: some lane's v may be
    // finite (else the minimum is INF, which changes nothing)
    auto close_diag = [&](int L, T v, int arg, bool any) {
      if (any) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const T ov = __shfl_xor_sync(kFull, v, off);
          const int ok = __shfl_xor_sync(kFull, arg, off);
          min_pair(v, arg, ov, ok);
        }
        if (!(v < INF)) arg = 0;  // an all-INF diagonal: argmin is lane 0
        if (v < min_e) {
          min_e = v;
          min_i = arg;
          min_j = L - arg;
          min_len = L;
          int dj = L - arg;
          dj = dj < 0 ? 0 : (dj > XW - 1 ? XW - 1 : dj);
          min_a = (a0 + extq[arg]) + extdb[dj];
        }
      }
      const bool stop =
          (L - min_len >= dropout) || ((L > maxq) && (L > maxd));
      ovf = ovf || (!stop && L >= W);
      active = !stop && L < W;
    };

    // the admission of cell (i, j): pair type, flag bits, helix test
    auto admit = [&](int i, int j, const uint8_t *mprev, int &t0, int &fl) {
      const int cq = qm[i], cd = dm[j];
      t0 = t0_of(cq, cd);
      fl = (t0 == 0 ? kZ : 0) | (wob(t0) ? kWb : 0) | (t0 > 2 ? kAU : 0) |
           (rt[t0] << kSt);
      bool bad = false;
      if (p.min_helix >= 2) {
        const int t1 = t0_of(qm[i + 1], dm[j + 1]);
        bad = t1 == 0 || (wob(t0) && wob(t1));
      }
      for (int x2 = 2; x2 < p.min_helix; ++x2)
        bad = bad || t0_of(qm[i + x2], dm[j + x2]) == 0;
      const int pm = mprev[i - 1];
      const bool gate = (pm & 1) || (wob(t0) && (pm & 2));
      return t0 != 0 && !(gate && bad);
    };

    // the raw (integer) loop energy of the special combo (u1, u2) (u1, u2
    // <= 2, no bulge) of a cell of pair type t0 whose predecessor has the
    // stored type tb; q1, q2, d1, d2: the characters 1 and 2 before the
    // cell (q2 read for u1 = 2, d2 for u2 = 2)
    auto special_raw = [&](int t0, int u1, int u2, int tb, int q1, int q2,
                           int d1, int d2) -> int {
      if (u1 + u2 <= 1)  // (0, 0), (0, 1), (1, 0)
        return (u1 + u2 ? b1 : 0) +
               (flag ? stack[tb * 7 + t0] : stack[t0 * 7 + tb]);
      if (u1 == 1 && u2 == 1)
        return flag ? i11[((tb * 8 + t0) * 5 + q1) * 5 + d1]
                    : i11[((t0 * 8 + tb) * 5 + q1) * 5 + d1];
      if (u1 == 1)  // (1, 2)
        return flag ? i21[(((tb * 8 + t0) * 5 + q1) * 5 + d1) * 5 + d2]
                    : i21[(((t0 * 8 + tb) * 5 + q1) * 5 + d2) * 5 + d1];
      if (u2 == 1)  // (2, 1)
        return flag ? i21[(((t0 * 8 + tb) * 5 + d1) * 5 + q2) * 5 + q1]
                    : i21[(((tb * 8 + t0) * 5 + d1) * 5 + q1) * 5 + q2];
      return flag  // (2, 2)
                 ? i22[((((tb * 8 + t0) * 5 + q2) * 5 + q1) * 5 + d1) * 5 + d2]
                 : i22[((((t0 * 8 + tb) * 5 + q1) * 5 + q2) * 5 + d2) * 5 +
                       d1];
    };
    auto ms_of = [&](int i, int j, int t0) {
      const int q1 = qm[i - 1], d1 = dm[j - 1];
      return flag ? mism[(t0 * 5 + d1) * 5 + q1] : mism[(t0 * 5 + q1) * 5 + d1];
    };

    // the work list: lane i is cell i
    const int i = lane;
    for (int L = 1; L <= W && active; ++L) {
      STAMP(const long long t_a = clock64();)
      n_diag = L;
      const int lo = max(1, L - maxd);
      const int hi = min(min(L - 1, maxq), W - 1);
      const int j = L - i;
      const bool band = lo <= i && i <= hi;
      const uint8_t *mprev = mt + (L & 1) * W;  // diagonal L - 2
      int t0 = 0, fl = 0;
      const bool adm = band && admit(i, j, mprev, t0, fl);
      const unsigned am = __ballot_sync(kFull, adm);
      STAMP(const long long t_b = clock64(); cyc_admit += t_b - t_a;
            n_band += __popc(__ballot_sync(kFull, band));
            n_adm += __popc(am);)
      T hyb = INF;
      int vmv = 0, pk = 0, mtb = 0;
      if (am) {
        if (adm) {
          cell[i] = (t0 << 16) | (ms_of(i, j, t0) & 0xffff);
          vmv = vm_of(t0, qm[i + 1], dm[j + 1]);
        }
        // lane s: loop size s, the ring row of the predecessors' diagonal
        // L - s - 2 (none below diagonal 0)
        const int s = lane;
        const int smax = min(dropout, L - 2);
        int r = 0;
        unsigned rm = 0;
        if (s <= smax) {
          r = (L - s - 2) % RH;
          rm = rmask[r];
        }
        const unsigned head = (unsigned)((r << 15) | (s << 10));
        int g = 0, gb = 0;   // entries listed in all, and before list[0]
        int gc = 0, nc = 0;  // this lane's cell's entries [gc, gc + nc)
        T run_min = INF;
        int run_q = 0;  // the cell's (31 - s, 31 - u1): stems order
        STAMP(int busiest = 0;)

        // entries [0, n) of the list: a combo (cell c, s, k) per lane and
        // round; the cell's lane keeps the minimum on (Et, stems order)
        auto run = [&](int n) {
          for (int t = 0; t < n; t += 32) {
            STAMP(++n_rounds;)
            T v = INF;
            int qc = -1;
            if (t + lane < n) {
              const unsigned en = list[t + lane];
              const int c = en & 31, k = (en >> 5) & 31,
                        es = (en >> 10) & 31;
              const int o = (int)(en >> 15) * W + k;  // the predecessor
              const int u1 = c - k - 1, u2 = es - u1, cj = L - c;
              const int cs = cell[c], ct0 = cs >> 16;
              int x;
              if (es >= 2 && (u1 == 0 || u2 == 0)) {  // bulge
                x = ((ct0 > 2 ? tau_i : 0) + cbul_i(es)) +
                    ((ring_f[o] & kAU) ? tau_i : 0);
              } else if (es <= 1 || (u1 <= 2 && u2 <= 2)) {
                x = special_raw(ct0, u1, u2, ring_f[o] >> kSt, qm[c - 1],
                                u1 == 2 ? qm[c - 2] : 0, dm[cj - 1],
                                u2 == 2 ? dm[cj - 2] : 0);
              } else {  // interior loop
                x = ((int)(int16_t)(cs & 0xffff) + cint_i(es)) + ring_vm[o];
              }
              v = d100(x) + ring_h[o];
              qc = (c << 10) | ((31 - es) << 5) | (31 - u1);
            }
            // segmented minimum towards the first lane of each cell's run
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
              const T ov = __shfl_down_sync(kFull, v, off);
              const int oq = __shfl_down_sync(kFull, qc, off);
              if (((oq ^ qc) >> 10) == 0 &&
                  (ov < v || (ov == v && oq < qc))) {
                v = ov;
                qc = oq;
              }
            }
            const int r0 = gb + t;
            const bool mine = nc > 0 && gc < r0 + 32 && gc + nc > r0;
            const int src = mine ? max(gc, r0) - r0 : lane;
            const T hv = __shfl_sync(kFull, v, src);
            const int hq = __shfl_sync(kFull, qc, src);
            if (mine && (hv < run_min || (hv == run_min && hq < run_q))) {
              run_min = hv;
              run_q = hq;
            }
          }
          __syncwarp();  // the list is read: it may be refilled
        };

        for (unsigned cells = am; cells; cells &= cells - 1) {
          const int c = __ffs(cells) - 1;
          // predecessors k = c - u1 - 1 of loop size s: c - s - 1 <= k <=
          // c - 1 (a ring row holds no finite cell past k = its diagonal
          // - 1, so u2 <= j - 1 needs no test)
          const int kl = c - s - 1;
          unsigned w =
              rm & ((1u << c) - 1u) & (kl > 0 ? ~((1u << kl) - 1u) : kFull);
          const int cnt = __popc(w);
          STAMP(busiest = max(busiest, cnt);
                n_steps += smax + 1;
                n_empty += __popc(__ballot_sync(kFull, s <= smax && !cnt));)
          // the lanes' counts before this one and in all, bit by bit
          // (a count has at most 5 bits, and mostly 1 or 2)
          const unsigned bits = __reduce_or_sync(kFull, (unsigned)cnt);
          if (!bits) continue;  // a cell without a combo
          int before = 0, tot = 0;
          for (int bit = 0; bits >> bit; ++bit) {
            const unsigned m = __ballot_sync(kFull, (cnt >> bit) & 1);
            before += __popc(m & ((1u << lane) - 1u)) << bit;
            tot += __popc(m) << bit;
          }
          if (lane == c) {
            gc = g;
            nc = tot;
          }
          int e = g + before;  // this lane's first entry
          g += tot;
          for (;;) {
            for (; w && e < gb + kList; ++e, w &= w - 1)
              list[e - gb] = head | ((__ffs(w) - 1) << 5) | c;
            if (g - gb < kList) break;
            __syncwarp();
            run(kList);
            gb += kList;
          }
        }
        if (g > gb) {
          __syncwarp();
          run(g - gb);
        }
        STAMP(n_combos += g; n_busiest += __reduce_add_sync(kFull, busiest);)
        if (adm && run_min < INF) {
          hyb = run_min;
          const int ws = 31 - ((run_q >> 5) & 31), u1 = 31 - (run_q & 31);
          const int f = ring_f[((L - ws - 2) % RH) * W + i - u1 - 1];
          const int pay = ((f & kZ) ? 16384 : 0) + ((f & kWb) ? 32768 : 0) +
                          (i * W + L - ((u1 + 1) * ME1 + ws - u1 + 1));
          pk = pay & 16383;
          mtb = ((pay & 16384) ? 1 : 0) | ((pay & 32768) ? 2 : 0);
        }
      }
      STAMP(const long long t_c = clock64(); cyc_combo += t_c - t_b;)
      const bool nopred = adm && !(hyb < INF);
      STAMP(n_nopred += __popc(__ballot_sync(kFull, nopred));)
      if (__any_sync(kFull, nopred)) {
        const int stem = stem0(L);
        if (nopred) mtb = stem;
      }
      STAMP(const long long t_d = clock64(); cyc_fallback += t_d - t_c;)
      const unsigned fm = __ballot_sync(kFull, adm && hyb < INF);
      T v = INF;
      int arg = 1 << 30;
      if (adm) min_pair(v, arg, (extq[i] + extdb[j]) + hyb, i);
      close_diag(L, v, arg, fm != 0);

      // every lane is done reading this diagonal's window: write row L
      __syncwarp();
      const int crow = (L % RH) * W;
      if (i < W) {
        ring_h[crow + i] = hyb;
        ring_f[crow + i] = (uint8_t)(fl | (adm ? kAdm : 0));
        if (band) ring_vm[crow + i] = (int8_t)vmv;
        mt[(L & 1) * W + i] = (uint8_t)(adm ? mtb : 1);
        pred[L * W + i] = (int16_t)(adm ? pk : -1);
      }
      if (lane == 0) rmask[L % RH] = fm;
      __syncwarp();
      STAMP(cyc_rest += clock64() - t_d;)
    }
    STAMP(const long long t_post = clock64();)

    // ---- 6. traceback over the predecessor rows ---------------------------
    if (lane == 0) {
      int ti = min_i, tj = min_j;
      for (int k = 0; k < steps; ++k) {
        const bool live = ti != 0 && tj != 0;
        tbs[k] = live ? ti : 0;
        tbs[steps + k] = live ? tj : 0;
        if (live) {
          int idx = (ti + tj) * W + ti;
          idx = idx < 0 ? 0 : (idx > ME1 * W - 1 ? ME1 * W - 1 : idx);
          const int pkd = max((int)pred[idx], 0);
          ti = pkd / ME1;
          tj = pkd % ME1;
        } else {
          ti = 0;
          tj = 0;
        }
      }
      int32_t *io = p.ints + 5 * b;
      io[0] = min_i;
      io[1] = min_j;
      io[2] = min_len;
      io[3] = ovf ? 1 : 0;
      io[4] = n_diag;
      p.floats[2 * b] = min_e;
      p.floats[2 * b + 1] = min_a;
    }
    __syncwarp();
    for (int k = lane; k < 2 * steps; k += 32)
      p.tb[b * 2 * steps + k] = tbs[k];
    __syncwarp();
    STAMP(const long long t_end = clock64(); cyc_post += t_end - t_post;
          cyc_hit += t_end - t_hit; ++n_hits; n_diags += n_diag;)
  }
#ifdef GAPPED_STAMPS
  if (lane == 0) {
    const long long v[kNStamps] = {
        n_hits, n_diags, n_band, n_adm, n_combos, n_steps, n_empty,
        n_busiest, n_rounds, n_nopred, cyc_hit, cyc_pre, cyc_admit, cyc_combo,
        cyc_fallback, cyc_rest, cyc_post};
    for (int k = 0; k < kNStamps; ++k)
      atomicAdd(g_stamps + k, (unsigned long long)v[k]);
  }
#endif
}

template <typename T>
size_t smem_bytes(int W, int XW, int dropout, int steps, int nspan,
                  int warps) {
  return (size_t)align16((kWords - kI21) * 2) +
         align16((2 * (dropout + 1) + nspan) * (int)sizeof(T)) + kPairBytes +
         (size_t)warps *
             warp_layout(W, XW, dropout + 2, steps, (int)sizeof(T)).total;
}

// the launch's warps per block and blocks per SM: the most warps in flight
// per SM, the fewest warps per block on a tie
template <typename T, int DROP>
int plan(const Params<T> &p, int *warps_out, int *blocks_out) {
  auto kern = extend_kernel<T, DROP>;
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (e != cudaSuccess) return (int)e;
  auto bytes = [&](int w) {
    return smem_bytes<T>(p.max_ext, p.XW, p.dropout, p.steps, p.nspan, w);
  };
  int warps = 0, best = 0;
  for (int w = 1; w <= 32 && bytes(w) <= (size_t)max_smem; ++w) {
    int nb = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kern, 32 * w,
                                                      bytes(w)) != cudaSuccess)
      break;
    if (nb * w > best) {
      best = nb * w;
      warps = w;
    }
  }
  if (warps <= 0) return (int)cudaErrorInvalidConfiguration;
  int nb = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kern, 32 * warps,
                                                    bytes(warps));
  if (e != cudaSuccess) return (int)e;
  if (nb < 1) return (int)cudaErrorInvalidConfiguration;
  *warps_out = warps;
  *blocks_out = nb;
  return 0;
}

// warps_in_flight: if not null, the launch is planned, not made, and its
// warps per SM are stored there
template <typename T, int DROP>
int launch_drop(const Params<T> &p, void *stream, int *warps_in_flight) {
  int warps = 0, nb = 0, dev = 0, n_sm = 0;
  const int e = plan<T, DROP>(p, &warps, &nb);
  if (e != 0 || warps_in_flight) {
    if (warps_in_flight) *warps_in_flight = warps * nb;
    return e;
  }
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const size_t sb =
      smem_bytes<T>(p.max_ext, p.XW, p.dropout, p.steps, p.nspan, warps);
  const int64_t need = (p.B + warps - 1) / warps;
  const int64_t cap = (int64_t)nb * n_sm;
  const int grid = (int)(need < cap ? need : cap);
  auto kern = extend_kernel<T, DROP>;
  kern<<<grid, 32 * warps, sb, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// ptrs: q_enc, db_seq, q_acc, q_cond, db_acc, db_cond, q_start, db_start,
//   id_anchor, qb, qab, dbb, aoff, coff, energy0, acc0, valid, tables,
//   consts, ints, floats, tb (22 device pointers);
// sizes: n_qenc, n_db, n_qacc, n_qcond, n_dacc, n_dcond, B;
// iparams: flag, d, dropout, min_helix, max_ext, XW, steps, rlo, nspan;
// max_ext outside 1..kWorkMax is refused before anything is touched
template <typename T>
int launch(void *const *ptrs, const long long *sizes, const int *iparams,
           void *stream, int *warps_in_flight = nullptr) {
  Params<T> p;
  p.q_enc = (const int64_t *)ptrs[0];
  p.db_seq = (const int64_t *)ptrs[1];
  p.q_acc = (const float *)ptrs[2];
  p.q_cond = (const float *)ptrs[3];
  p.db_acc = (const float *)ptrs[4];
  p.db_cond = (const float *)ptrs[5];
  p.q_start = (const int64_t *)ptrs[6];
  p.db_start = (const int64_t *)ptrs[7];
  p.id_anchor = (const int64_t *)ptrs[8];
  p.qb = (const int64_t *)ptrs[9];
  p.qab = (const int64_t *)ptrs[10];
  p.dbb = (const int64_t *)ptrs[11];
  p.aoff = (const int64_t *)ptrs[12];
  p.coff = (const int64_t *)ptrs[13];
  p.energy0 = (const T *)ptrs[14];
  p.acc0 = (const T *)ptrs[15];
  p.valid = (const uint8_t *)ptrs[16];
  p.tables = (const int16_t *)ptrs[17];
  p.consts = (const T *)ptrs[18];
  p.ints = (int32_t *)ptrs[19];
  p.floats = (T *)ptrs[20];
  p.tb = (int32_t *)ptrs[21];
  p.n_qenc = sizes[0];
  p.n_db = sizes[1];
  p.n_qacc = sizes[2];
  p.n_qcond = sizes[3];
  p.n_dacc = sizes[4];
  p.n_dcond = sizes[5];
  p.B = sizes[6];
  p.flag = iparams[0];
  p.d = iparams[1];
  p.dropout = iparams[2];
  p.min_helix = iparams[3];
  p.max_ext = iparams[4];
  p.XW = iparams[5];
  p.steps = iparams[6];
  p.rlo = iparams[7];
  p.nspan = iparams[8];
  if (p.max_ext < 1 || p.max_ext > kWorkMax)
    return (int)cudaErrorInvalidValue;
  if (p.B == 0 && !warps_in_flight) return 0;
  if (p.dropout == 16) return launch_drop<T, 16>(p, stream, warps_in_flight);
  return launch_drop<T, 0>(p, stream, warps_in_flight);
}

}  // namespace

extern "C" int gapped_extend_f32(void *const *ptrs, const long long *sizes,
                                 const int *iparams, void *stream) {
  return launch<float>(ptrs, sizes, iparams, stream);
}

extern "C" int gapped_extend_f64(void *const *ptrs, const long long *sizes,
                                 const int *iparams, void *stream) {
  return launch<double>(ptrs, sizes, iparams, stream);
}

// the warps per SM a launch of these arguments would keep in flight
// (dbl: float64), in *out
extern "C" int gapped_extend_warps(void *const *ptrs, const long long *sizes,
                                   const int *iparams, int dbl, int *out) {
  return dbl ? launch<double>(ptrs, sizes, iparams, nullptr, out)
             : launch<float>(ptrs, sizes, iparams, nullptr, out);
}

#ifdef GAPPED_STAMPS
// the instrumented build's sums (kNStamps words), then cleared
extern "C" int gapped_extend_stamps(unsigned long long *out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[kNStamps] = {};
  return (int)cudaMemcpyToSymbol(g_stamps, zero, sizeof(g_stamps));
}
#endif
