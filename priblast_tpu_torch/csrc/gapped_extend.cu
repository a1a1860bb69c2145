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
// (20 KB) and the loop constants into shared memory once; int22 (80 KB) is
// read from device memory through the L1 cache (in shared memory it leaves
// room for fewer warps per SM, and measured slower). The launch takes the
// warps per block that put the most warps in flight per SM.
// Each warp works on its own region of shared memory (rings of the last
// dropout + 2 diagonals: hyb, VM as int16, flag bits and, for max_ext <= 32,
// a mask of the lanes that hold a finite hyb; the two rows of
// helix-admission bits; the predecessor rows; the character windows and
// prefix chains) and syncs with __syncwarp only. On diagonal L only the
// band cells max(1, L - maxd) <= i <= min(L - 1, maxq) are worked on (~8
// on the main path): each gets G lanes (G * band <= 32, a power of two),
// which deal its predecessors k out by k % G and then reduce on the pair
// (Et, stems-order index), so the first minimum still wins; a band wider
// than 32 falls back to one lane per cell and up to NC cells per lane
// (NC = 1, 2, 4 for max_ext <= 32, 64, 128). Cells that are not admitted
// do no combo work, and a combo whose predecessor lies outside the band or
// holds INF is skipped (INF + x < run_min is never true, so this changes
// no bit): for max_ext <= 32 a lane walks the set bits of the ring row's
// mask, else it tests each predecessor. The winning combo's payload is
// derived once, after the loop. The loop over s stays rolled (unrolled,
// its code measured slower); the template parameter DROP = 16, the main
// path's dropout (DROP = 0 is the generic path), makes the ring length a
// compile-time constant. Every loop energy of s <= 30 is an integer sum
// (exact in float and double), so x / 100 is looked up in a table of the
// quotients the division gives (built on the host in the working dtype);
// other values divide. The wrapper builds with -maxrregcount=64: the warps
// in flight this allows outweigh the spills.
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
// ring flag bits of a cell: admitted, pair type 0, wobble, terminal AU
constexpr int kAdm = 1, kZ = 2, kWb = 4, kAU = 8;

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

// byte offsets of one warp's region of shared memory
struct WarpLayout {
  int ring_h, extq, extdb, ring_vm, pred, tbs, rmask, ring_f, mt, qm, dm,
      total;
};

__host__ __device__ inline WarpLayout warp_layout(int W, int XW, int RH,
                                                  int steps, int tsize) {
  WarpLayout l;
  int off = 0;
  l.ring_h = off;  off += align16(RH * W * tsize);
  l.extq = off;    off += align16(XW * tsize);
  l.extdb = off;   off += align16(XW * tsize);
  l.ring_vm = off; off += align16(RH * W * 2);
  l.pred = off;    off += align16((W + 1) * W * 2);
  l.tbs = off;     off += align16(2 * steps * 4);
  l.rmask = off;   off += align16(RH * 4);
  l.ring_f = off;  off += align16(RH * W);
  l.mt = off;      off += align16(2 * W);
  l.qm = off;      off += align16(XW);
  l.dm = off;      off += align16(XW);
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

template <typename T, int DROP, int NC>
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
  const T tau = T(tau_i);
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
  unsigned char *wb = smem + tab_bytes + cst_bytes + warp * wl.total;
  T *ring_h = reinterpret_cast<T *>(wb + wl.ring_h);
  T *extq = reinterpret_cast<T *>(wb + wl.extq);
  T *extdb = reinterpret_cast<T *>(wb + wl.extdb);
  int16_t *ring_vm = reinterpret_cast<int16_t *>(wb + wl.ring_vm);
  int16_t *pred = reinterpret_cast<int16_t *>(wb + wl.pred);
  int32_t *tbs = reinterpret_cast<int32_t *>(wb + wl.tbs);
  // per ring row, bit k: lane k holds a finite hyb (max_ext <= 32)
  uint32_t *rmask = reinterpret_cast<uint32_t *>(wb + wl.rmask);
  uint8_t *ring_f = wb + wl.ring_f;
  uint8_t *mt = wb + wl.mt;  // [2][W]: bit 0 type-0 bit, bit 1 wobble bit
  uint8_t *qm = wb + wl.qm;
  uint8_t *dm = wb + wl.dm;

  auto t0_of = [&](int a, int b) {
    const int t = bp[a * 5 + b];
    return flag ? rt[t] : t;
  };
  auto st_of = [&](int a, int b) { return rt[t0_of(a, b)]; };
  auto vm_of = [&](int t, int q1, int d1) {
    const int s = rt[t];
    return flag ? mism[(s * 5 + q1) * 5 + d1] : mism[(s * 5 + d1) * 5 + q1];
  };
  const int sgn = flag ? 1 : -1;

  for (int64_t b = (int64_t)blockIdx.x * nwarps + warp; b < p.B;
       b += (int64_t)gridDim.x * nwarps) {
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
                  (wob(to) ? kWb : 0) | (to > 2 ? kAU : 0);
      ring_vm[0] = (int16_t)vm_of(to, qm[1], dm[1]);
    }
    __syncwarp();

    // ---- 5. the sweep -----------------------------------------------------
    bool active = valid, ovf = false;
    T min_e = e0, min_a = a0;
    int min_i = 0, min_j = 0, min_len = 0, n_diag = 0;
    for (int L = 1; L <= W && active; ++L) {
      n_diag = L;
      const int lo = max(1, L - maxd);
      const int hi = min(min(L - 1, maxq), W - 1);
      const int nb = hi - lo + 1;  // band cells of this diagonal
      // G lanes per band cell (a power of two, G * nb <= 32): the cell's
      // combos are dealt out over its G lanes, then reduced on (Et, stems
      // order), which keeps the first minimum
      int G = 1;
      while (nb > 0 && G * 2 * nb <= 32) G <<= 1;
      const int g = lane & (G - 1);
      const int slot0 = lane / G, slots = 32 / G;
      // the predecessor lanes k this lane takes: k % G == g
      const unsigned pat = (G >= 32 ? 1u : 0xffffffffu / ((1u << G) - 1))
                           << g;
      const uint8_t *mprev = mt + (L & 1) * W;  // diagonal L - 2
      T hyb[NC];
      int cell[NC], fl[NC], vmv[NC], pk[NC], mtb[NC];
      bool adm[NC], nopred[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int i = lo + slot0 + slots * c, j = L - i;
        cell[c] = i <= hi ? i : -1;
        fl[c] = 0;
        vmv[c] = 0;
        adm[c] = false;
        T run_min = INF;
        int run_pay = 0, run_idx = 1 << 30;
        if (i <= hi) {
          const int cq = qm[i], cd = dm[j];
          const int t0 = t0_of(cq, cd);
          fl[c] = (t0 == 0 ? kZ : 0) | (wob(t0) ? kWb : 0) |
                  (t0 > 2 ? kAU : 0);
          bool bad = false;
          if (p.min_helix >= 2) {
            const int t1 = t0_of(qm[i + 1], dm[j + 1]);
            bad = t1 == 0 || (wob(t0) && wob(t1));
          }
          for (int x2 = 2; x2 < p.min_helix; ++x2)
            bad = bad || t0_of(qm[i + x2], dm[j + x2]) == 0;
          const int pm = mprev[i - 1];
          const bool gate = (pm & 1) || (wob(t0) && (pm & 2));
          adm[c] = t0 != 0 && !(gate && bad);
        }
        if (adm[c]) {
          const int t0 = t0_of(qm[i], dm[j]);
          // the cell's energies, from the characters around it
          const int q1 = qm[i - 1], q2 = i >= 2 ? qm[i - 2] : 0,
                    q3 = i >= 3 ? qm[i - 3] : 0;
          const int d1 = dm[j - 1], d2 = j >= 2 ? dm[j - 2] : 0,
                    d3 = j >= 3 ? dm[j - 3] : 0;
          auto stk = [&](int pt) {
            return flag ? stack[pt * 7 + t0] : stack[t0 * 7 + pt];
          };
          const int ms = flag ? mism[(t0 * 5 + d1) * 5 + q1]
                              : mism[(t0 * 5 + q1) * 5 + d1];
          const T sp1 = d100(stk(st_of(q1, d1)));
          const T sp2 = d100(b1 + stk(st_of(q2, d1)));
          const T sp3 = d100(b1 + stk(st_of(q1, d2)));
          int tb = st_of(q2, d2);
          const T sp4 = d100(flag ? i11[((tb * 8 + t0) * 5 + q1) * 5 + d1]
                                  : i11[((t0 * 8 + tb) * 5 + q1) * 5 + d1]);
          tb = st_of(q2, d3);
          const T sp5 = d100(
              flag ? i21[(((tb * 8 + t0) * 5 + q1) * 5 + d1) * 5 + d2]
                   : i21[(((t0 * 8 + tb) * 5 + q1) * 5 + d2) * 5 + d1]);
          tb = st_of(q3, d2);
          const T sp6 = d100(
              flag ? i21[(((t0 * 8 + tb) * 5 + d1) * 5 + q2) * 5 + q1]
                   : i21[(((tb * 8 + t0) * 5 + d1) * 5 + q1) * 5 + q2]);
          tb = st_of(q3, d3);
          const T sp7 = d100(
              flag ? i22[((((tb * 8 + t0) * 5 + q2) * 5 + q1) * 5 + d1) * 5 +
                         d2]
                   : i22[((((t0 * 8 + tb) * 5 + q1) * 5 + q2) * 5 + d2) * 5 +
                         d1]);
          const int au_f = t0 > 2 ? tau_i : 0;
          const T au_fT = t0 > 2 ? tau : T(0);
          const T msT = T(ms);
          const int base_pk = i * W + L;
          int run_su = 0;  // (s << 8) | u1 of the running minimum

          // one combo (s, u1): the predecessor k = i - u1 - 1 of the ring
          // row of diagonal L - s - 2 holds the finite hyb ph
          auto combo = [&](int s, int u1, int k, T ph, const int16_t *rv,
                           const uint8_t *rf, int order0) {
            const int u2 = s - u1;
            T Et;
            if (s >= 2 && (u1 == 0 || u2 == 0)) {
              const int au_p = (rf[k] & kAU) ? tau_i : 0;
              Et = (s <= 30 ? d100((au_f + cbul_i(s)) + au_p)
                            : ((au_fT + cbul[s]) + (au_p ? tau : T(0))) /
                                  hundred) + ph;
            } else if (s <= 1 || (u1 <= 2 && u2 <= 2)) {
              const T sp = (u1 == 0 && u2 == 0)   ? sp1
                           : (u2 == 0)            ? sp2
                           : (u1 == 0)            ? sp3
                           : (u1 == 1 && u2 == 1) ? sp4
                           : (u1 == 1)            ? sp5
                           : (u2 == 1)            ? sp6
                                                  : sp7;
              Et = sp + ph;
            } else {
              Et = (s <= 30 ? d100((ms + cint_i(s)) + rv[k])
                            : ((msT + cint[s]) + T(rv[k])) / hundred) + ph;
            }
            if (Et < run_min) {
              run_min = Et;
              run_idx = order0 - u1;
              run_su = (s << 8) | u1;
            }
          };

#pragma unroll 1
          for (int s = dropout; s >= 0; --s) {
            const int Dp = L - s - 2;  // the predecessors' diagonal
            if (Dp < 0) continue;
            const int r = Dp % RH;
            if (NC == 1 && rmask[r] == 0) continue;  // no finite predecessor
            const T *rh = ring_h + r * W;
            const int16_t *rv = ring_vm + r * W;
            const uint8_t *rf = ring_f + r * W;
            // stems order of (s, u1): combos of larger s come first
            const int order0 = ((dropout + 1) * (dropout + 2) -
                                (s + 1) * (s + 2)) / 2 + s;
            // predecessor (i - u1 - 1, j - u2 - 1) needs u1 < i, u2 < j;
            // the lane visits its combos in increasing k (decreasing u1,
            // increasing stems order) and strict < keeps the first minimum
            const int uhi = min(s, i - 1), ulo = max(0, s - (j - 1));
            const int klo = i - uhi - 1, khi = i - ulo - 1;
            if (NC == 1) {
              // only the finite predecessors, from the row's mask
              unsigned m = rmask[r] & pat & ((2u << khi) - (1u << klo));
              while (m) {
                const int k = __ffs(m) - 1;
                m &= m - 1;
                combo(s, i - k - 1, k, rh[k], rv, rf, order0);
              }
            } else {
              for (int k = klo + ((g - klo) & (G - 1)); k <= khi; k += G) {
                const T ph = rh[k];
                if (ph < INF) combo(s, i - k - 1, k, ph, rv, rf, order0);
              }
            }
          }
          if (run_min < INF) {
            const int s = run_su >> 8, u1 = run_su & 255, u2 = s - u1;
            const int f = ring_f[((L - s - 2) % RH) * W + i - u1 - 1];
            run_pay = ((f & kZ) ? 16384 : 0) + ((f & kWb) ? 32768 : 0) +
                      (base_pk - ((u1 + 1) * ME1 + u2 + 1));
          }
          vmv[c] = vm_of(t0, qm[i + 1], dm[j + 1]);
        }
        // the cell's minimum over its G lanes
        for (int off = 1; off < G; off <<= 1) {
          const T ov = __shfl_xor_sync(kFull, run_min, off);
          const int oi = __shfl_xor_sync(kFull, run_idx, off);
          const int op = __shfl_xor_sync(kFull, run_pay, off);
          if (ov < run_min || (ov == run_min && oi < run_idx)) {
            run_min = ov;
            run_idx = oi;
            run_pay = op;
          }
        }
        hyb[c] = run_min;
        nopred[c] = !(run_min < INF);
        const int pay = run_pay > 0 ? run_pay : 0;
        pk[c] = nopred[c] ? 0 : (pay & 16383);
        mtb[c] = ((pay & 16384) ? 1 : 0) | ((pay & 32768) ? 2 : 0);
      }

      // stems[0] fallback for admitted cells without a predecessor: the
      // first admitted cell of the window in (diagonal, lane) order
      bool need = false;
#pragma unroll
      for (int c = 0; c < NC; ++c) need = need || (adm[c] && nopred[c]);
      if (__any_sync(kFull, need)) {
        int stem = 1;  // none admitted: type-0 bit set, wobble bit clear
        bool found = false;
        for (int r = 0; r < RH && !found; ++r) {
          const int D = L - RH + r;
          if (D < 0) continue;
          const uint8_t *rf = ring_f + (D % RH) * W;
          for (int c = 0; c < NC && !found; ++c) {
            const int i = lane + 32 * c;
            const unsigned m = __ballot_sync(kFull, i < W && (rf[i] & kAdm));
            if (m) {
              const int f = rf[32 * c + __ffs(m) - 1];
              stem = ((f & kZ) ? 1 : 0) | ((f & kWb) ? 2 : 0);
              found = true;
            }
          }
        }
#pragma unroll
        for (int c = 0; c < NC; ++c)
          if (adm[c] && nopred[c]) mtb[c] = stem;
      }

      // running minimum of extq + extdb + hyb over the diagonal
      T v = INF;
      int arg = 1 << 30;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int i = cell[c];
        if (adm[c] && g == 0)
          min_pair(v, arg, (extq[i] + extdb[L - i]) + hyb[c], i);
      }
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
      const bool stop =
          (L - min_len >= dropout) || ((L > maxq) && (L > maxd));
      ovf = ovf || (!stop && L >= W);
      active = !stop && L < W;

      // every lane is done reading this diagonal's window: write row L,
      // first the empty cells, then the band cells from their first lane
      __syncwarp();
      const int crow = (L % RH) * W;
      uint8_t *mcur = mt + (L & 1) * W;
      for (int i = lane; i < W; i += 32) {
        ring_h[crow + i] = INF;
        ring_f[crow + i] = 0;
        mcur[i] = 1;
        pred[L * W + i] = -1;
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int i = cell[c];
        if (i < 0 || g != 0) continue;
        ring_h[crow + i] = adm[c] ? hyb[c] : INF;
        ring_f[crow + i] = (uint8_t)(fl[c] | (adm[c] ? kAdm : 0));
        ring_vm[crow + i] = (int16_t)vmv[c];
        mcur[i] = (uint8_t)(adm[c] ? mtb[c] : 1);
        pred[L * W + i] = (int16_t)(adm[c] ? pk[c] : -1);
      }
      if (NC == 1) {
        const bool fin = cell[0] >= 0 && g == 0 && adm[0] && hyb[0] < INF;
        const unsigned rm = __reduce_or_sync(kFull, fin ? 1u << cell[0] : 0u);
        if (lane == 0) rmask[L % RH] = rm;
      }
      __syncwarp();
    }

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
  }
}

template <typename T>
size_t smem_bytes(int W, int XW, int dropout, int steps, int nspan,
                  int warps) {
  return (size_t)align16((kWords - kI21) * 2) +
         align16((2 * (dropout + 1) + nspan) * (int)sizeof(T)) +
         (size_t)warps *
             warp_layout(W, XW, dropout + 2, steps, (int)sizeof(T)).total;
}

template <typename T, int DROP, int NC>
int launch_nc(const Params<T> &p, void *stream) {
  auto kern = extend_kernel<T, DROP, NC>;
  int dev = 0, n_sm = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (e != cudaSuccess) return (int)e;
  auto bytes = [&](int w) {
    return smem_bytes<T>(p.max_ext, p.XW, p.dropout, p.steps, p.nspan, w);
  };
  // warps per block: the most warps in flight per SM, the fewest warps per
  // block on a tie
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
  const size_t sb = bytes(warps);
  int nb = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kern, 32 * warps,
                                                    sb);
  if (e != cudaSuccess) return (int)e;
  if (nb < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t need = (p.B + warps - 1) / warps;
  const int64_t cap = (int64_t)nb * n_sm;
  const int grid = (int)(need < cap ? need : cap);
  kern<<<grid, 32 * warps, sb, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int DROP>
int launch_drop(const Params<T> &p, void *stream) {
  if (p.max_ext <= 32) return launch_nc<T, DROP, 1>(p, stream);
  if (p.max_ext <= 64) return launch_nc<T, DROP, 2>(p, stream);
  return launch_nc<T, DROP, 4>(p, stream);
}

// ptrs: q_enc, db_seq, q_acc, q_cond, db_acc, db_cond, q_start, db_start,
//   id_anchor, qb, qab, dbb, aoff, coff, energy0, acc0, valid, tables,
//   consts, ints, floats, tb (22 device pointers);
// sizes: n_qenc, n_db, n_qacc, n_qcond, n_dacc, n_dcond, B;
// iparams: flag, d, dropout, min_helix, max_ext, XW, steps, rlo, nspan
template <typename T>
int launch(void *const *ptrs, const long long *sizes, const int *iparams,
           void *stream) {
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
  if (p.B == 0) return 0;
  if (p.dropout == 16) return launch_drop<T, 16>(p, stream);
  return launch_drop<T, 0>(p, stream);
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
