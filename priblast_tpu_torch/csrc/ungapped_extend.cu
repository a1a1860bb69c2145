// Ungapped extension for Hopper (sm_90a): a thread per hit, each hit run
// to its own stop, with the values of a step carried to the next, 32-bit
// positions and each step's loads issued a step ahead.
//
// Replaces the XLA device programs that compute the ungapped extension in
// the JAX package: priblast_tpu/search/ungapped.py:ungapped_core (:94, a
// lockstep while-loop over the batch that runs as many steps as its slowest
// hit) and priblast_tpu/search/uwin.py:ungapped_window (:261, a fixed
// window of the same steps, with ungapped_core re-running every lane the
// window leaves unfinished). Both compute the same function; with a loop
// per thread there is no window and no tail. Reference semantics:
// src/ungapped_extension.cpp:30-186.
//
// The arithmetic follows the plain PyTorch version,
// search/ungapped.py:ungapped_extend_flat, operation for operation in
// float32, so both give the same bits: build with -fmad=false and without
// fast-math (no contraction, every /100 an IEEE division). The plain
// version's masked "+ 0" adds are kept (-0.0f + 0.0f is +0.0f), and so is
// its strict < for the running minimum (the first argmin on ties). Every
// buffer position is clamped to its buffer, as the plain version's `_at`
// does, and every table index to its table, as `_take` does; a table is
// read only where its value is used.
//
// Per hit: the left phase steps from (q_sp, db_sp) down until a blocked
// character, a buffer edge or the dropout; then the right phase steps from
// the seed's end up. A step adds the accessibility increment, the loop
// energy of a paired step (looked up from the characters in the Turner
// tables) and keeps the running minimum with its argmin.
//
// Bound on this card: bytes. A step reads two characters (int64) and three
// accessibility entries (float32) at positions that follow the hit. The
// steps of one hit are a chain, so the kernel's time is its instructions
// and its latencies, which the design cuts:
// - nothing is loaded twice: a thread carries the previous step's
//   accessibility entry (q_acc left, db_acc right), the pair type of the
//   last pair, the previous step's characters (just inside the new pair)
//   and those of the step after the last pair (just inside the last
//   pair), each the plain version's load at the same clamped position;
// - 32-bit positions: each hit's 64-bit base positions are narrowed once
//   (`narrow`), then every step clamps and indexes in 32 bits;
// - loads a step ahead: a step's five loads are issued before the step
//   before it computes (every load is clamped, so a load past the phase's
//   end is harmless), so no load from device memory is on a step's chain
//   but the int11 and int22 lookups;
// - at most 64 registers (__launch_bounds__(256, 4)): 32 warps per SM hide
//   the latencies that remain.
// Refilling a warp's lanes from its own range of hits as they stop (one
// step body for both phases, a ballot to hand out hits) keeps 92% of the
// lanes busy against 61% here, but costs more than it saves on this card:
// the body with both phases, the hand-out and each new hit's loads took
// 0.81-1.10 ms on the main path's first batch, against 0.43 ms for this
// kernel (PERF.md; ungapped_ab.py).
// The small tables (BP_pair, rtype, stack37, mismatchI37, internal_loop37:
// 1,148 bytes) live in shared memory; int11 and int22 are read through the
// read-only cache (__ldg): staging int11 in every block cost more than it
// saved. int21 is never read: both coordinates move together, so a loop
// has as many unpaired bases on each side (u1 = u2;
// tests/test_torch_kernel_emu.py holds the plain version to that).
//
// C entry point (ctypes): ungapped_extend. It launches on the given stream
// and returns cudaGetLastError(), or cudaErrorInvalidValue for a buffer or
// batch of more than 2^30 entries.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // threads per block
constexpr int kMinBlocks = 4;   // blocks per SM: at most 64 registers
constexpr int kMaxSize = 1 << 30;  // entries per buffer, hits per batch
// table sizes (entries) and the shared-memory layout of the small ones
constexpr int kNBp = 25, kNRt = 7, kNStack = 49, kNMism = 175,
              kNIntloop = 31, kNI11 = 1600, kNI22 = 40000;
constexpr int kSmemBytes = 4 * (kNBp + kNRt + kNStack + kNMism + kNIntloop);

struct Params {
  const int64_t *q_enc, *db_seq;
  const float *q_acc, *q_cond, *db_acc, *db_cond;
  const int64_t *q_sp, *db_sp, *length, *dbseq_start, *qb, *qab, *dbb,
      *aoff, *coff;
  const float *acc_e, *hyb_e;
  const int64_t *bp, *rtype;
  const float *stack, *mism, *intloop, *i11, *i22;
  int64_t *ints;   // [4, B]: q_sp, db_sp, new length (q_len = db_len),
                   //         dbseq_start
  float *floats;   // [3, B]: acc_e, hyb_e, energy
  int n_qenc, n_db, n_qacc, n_qcond, n_dacc, n_dcond;
  int64_t B;
  int d, dropout;
};

struct Tables {
  const int *bp, *rt;
  const float *stack, *mism, *intloop, *i11, *i22;
};

// A phase takes at most kSlack steps, with exact 32-bit positions: a hit's
// 64-bit base position in a buffer of n <= kMaxSize entries is narrowed to
// [-kSlack, n - 1 + kSlack], which moves no position base +- s
// (s <= kSlack) across the clamp to [0, n - 1], and keeps base +- (s + 1)
// (the loads a step ahead) within int32. Both loops stop after kSlack
// steps, where the plain version would go on; no real phase comes near it
// (a sequence ends at a terminator).
constexpr int kSlack = (1 << 29) - 1;

__device__ __forceinline__ int narrow(int64_t pos, int n) {
  return (int)(pos < -kSlack ? -kSlack
                             : (pos > n - 1 + kSlack ? n - 1 + kSlack : pos));
}

__device__ __forceinline__ int clamp_pos(int pos, int n) {
  return pos < 0 ? 0 : (pos > n - 1 ? n - 1 : pos);
}

// an encoded character (0..9, utils/alphabet.py), read as int
__device__ __forceinline__ int at(const int64_t *buf, int n, int pos) {
  return (int)__ldg(reinterpret_cast<const long long *>(buf)
                    + clamp_pos(pos, n));
}

__device__ __forceinline__ float at(const float *buf, int n, int pos) {
  return __ldg(buf + clamp_pos(pos, n));
}

__device__ __forceinline__ int mapc(int v) {
  // encoded char -> energy index (2..5 -> 1..4; soft-masked 6..9 -> 1..4)
  return v <= 5 ? v - 1 : v - 5;
}

__device__ __forceinline__ int pair_type(const Tables &t, int qc, int dc) {
  return t.bp[clamp_pos(mapc(qc) * 5 + mapc(dc), kNBp)];
}

__device__ __forceinline__ int rtype_of(const Tables &t, int type) {
  return t.rt[clamp_pos(type, kNRt)];
}

// Hybridization loop energy / 100, no-bulge variant (reference:
// src/ungapped_extension.cpp:157-186), for an outer pair of type type1 and
// an inner pair of type type2 with u unpaired bases on each side (u1 = u2
// = u: the plain version's int21 branches, u1 + u2 = 3, are never taken).
// a, b are the characters just inside the outer pair, c, dch just inside
// the inner one (query, db), as the plain version reads them.
__device__ float loop37(const Tables &t, int type1, int type2, int a, int b,
                        int c, int dch, int u) {
  float z;
  if (u == 0) {
    z = t.stack[clamp_pos(type1 * 7 + type2, kNStack)];
  } else {
    a = mapc(a);
    b = mapc(b);
    c = mapc(c);
    dch = mapc(dch);
    const int t12 = type1 * 8 + type2;
    if (u == 1) {
      z = __ldg(t.i11 + clamp_pos((t12 * 5 + a) * 5 + b, kNI11));
    } else if (u == 2) {
      z = __ldg(t.i22 + clamp_pos((((t12 * 5 + a) * 5 + c) * 5 + dch) * 5 + b,
                                  kNI22));
    } else {
      const int uu = 2 * u;
      z = t.intloop[uu > 30 ? 30 : uu]
          + t.mism[clamp_pos((type1 * 5 + a) * 5 + b, kNMism)];
      z = z + t.mism[clamp_pos((type2 * 5 + dch) * 5 + c, kNMism)];
    }
  }
  return z / 100.0f;
}

// launched with kThreads threads per block; blockDim.x, not kThreads, in
// the body: with the constant nvcc's code took 1.5% longer (PERF.md)
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ungapped_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  int *s_bp = reinterpret_cast<int *>(smem);
  int *s_rt = s_bp + kNBp;
  float *s_stack = reinterpret_cast<float *>(s_rt + kNRt);
  float *s_mism = s_stack + kNStack;
  float *s_intloop = s_mism + kNMism;
  for (int k = threadIdx.x; k < kNBp; k += blockDim.x) s_bp[k] = (int)P.bp[k];
  for (int k = threadIdx.x; k < kNRt; k += blockDim.x)
    s_rt[k] = (int)P.rtype[k];
  for (int k = threadIdx.x; k < kNStack; k += blockDim.x)
    s_stack[k] = P.stack[k];
  for (int k = threadIdx.x; k < kNMism; k += blockDim.x) s_mism[k] = P.mism[k];
  for (int k = threadIdx.x; k < kNIntloop; k += blockDim.x)
    s_intloop[k] = P.intloop[k];
  __syncthreads();
  const Tables t{s_bp, s_rt, s_stack, s_mism, s_intloop, P.i11, P.i22};

  const int64_t h = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= P.B) return;
  const int64_t q_sp = P.q_sp[h], db_sp = P.db_sp[h], length = P.length[h];
  const int64_t dbseq_start = P.dbseq_start[h];
  const int64_t qb = P.qb[h], qab = P.qab[h], dbb = P.dbb[h];
  const int64_t aoff = P.aoff[h], coff = P.coff[h];
  const int d = P.d, dropout = P.dropout;
  const float acc0 = P.acc_e[h], hyb0 = P.hyb_e[h];
  const float energy0 = acc0 + hyb0;

  // ---- left phase (reference :55-94) ----
  // Step sn reads the query at q_sp - sn and the db at db_sp - sn. Carried
  // between steps instead of loaded again: q_acc at the previous position
  // (acc_prev), the pair type of the last pair (tp), the previous step's
  // characters (pq, pd: just inside the new pair) and the characters of
  // the step after the last pair (iq, id: just inside it). Each is the
  // load the plain version makes, at the same clamped position.
  // Positions are 32-bit: each buffer's base narrowed once (narrow).
  const int64_t m = q_sp < db_sp ? q_sp : db_sp;  // i_n or j_n < 0 past it
  const int lim = (int)(m < -1 ? -1 : (m > kSlack ? kSlack : m));
  int bq = narrow(qb + q_sp, P.n_qenc), bd = narrow(dbb + db_sp, P.n_db);
  int ba = narrow(qab + q_sp, P.n_qacc), bb = narrow(qab + q_sp + d, P.n_qcond);
  int bc = narrow(coff + dbseq_start + length - 1, P.n_dcond);
  float e = energy0, a = acc0, hh = hyb0;
  float min_e = energy0, min_a = acc0, min_h = hyb0;
  int s_pair = 0, s_min_l = 0;
  int pq = at(P.q_enc, P.n_qenc, bq), pd = at(P.db_seq, P.n_db, bd);
  int tp = pair_type(t, pq, pd);
  int iq = 0, id = 0;
  float acc_prev = at(P.q_acc, P.n_qacc, ba);
  // step sn's five loads are issued during step sn - 1 (a clamped load
  // past the phase's end is harmless)
  int qc = at(P.q_enc, P.n_qenc, bq - 1), dc = at(P.db_seq, P.n_db, bd - 1);
  float xa = at(P.q_acc, P.n_qacc, ba - 1), xb = at(P.q_cond, P.n_qcond, bb - 1);
  float xc = at(P.db_cond, P.n_dcond, bc + 1);
  for (int sn = 1;; ++sn) {
    if (sn > lim || qc < 2 || dc < 2) break;
    const int qc_n = at(P.q_enc, P.n_qenc, bq - sn - 1);
    const int dc_n = at(P.db_seq, P.n_db, bd - sn - 1);
    const float xa_n = at(P.q_acc, P.n_qacc, ba - sn - 1);
    const float xb_n = at(P.q_cond, P.n_qcond, bb - sn - 1);
    const float xc_n = at(P.db_cond, P.n_dcond, bc + sn + 1);
    const float dacc = ((xa - acc_prev) + xb) + xc;
    acc_prev = xa;
    e = e + dacc;
    a = a + dacc;
    const int u = sn - s_pair - 1;
    if (u == 0) {
      iq = qc;
      id = dc;
    }
    const int type1 = pair_type(t, qc, dc);
    const bool paired = type1 != 0;
    float le = 0.0f;
    if (paired) le = loop37(t, type1, rtype_of(t, tp), pq, pd, iq, id, u);
    e = e + le;
    hh = hh + le;
    if (paired && e < min_e) {
      min_e = e;
      min_a = a;
      min_h = hh;
      s_min_l = sn;
    }
    if (paired) {
      s_pair = sn;
      tp = type1;
    }
    pq = qc;
    pd = dc;
    if (sn - s_min_l >= dropout) break;
    qc = qc_n;
    dc = dc_n;
    xa = xa_n;
    xb = xb_n;
    xc = xc_n;
  }

  // ---- right phase (reference :96-145) ----
  // Step sn reads the query at k0 + sn, the db at l0 + sn and the db
  // accessibility at dbseq_start - sn. Carried as in the left phase; here
  // the previous step's characters are just inside the new (inner) pair
  // and those of the step after the last pair just inside the last
  // (outer) one.
  const int64_t k0 = q_sp + length - 1, l0 = db_sp + length - 1;
  bq = narrow(qb + k0, P.n_qenc);
  bd = narrow(dbb + l0, P.n_db);
  ba = narrow(qab + k0, P.n_qcond);
  bb = narrow(aoff + dbseq_start, P.n_dacc);
  bc = narrow(coff + dbseq_start + d, P.n_dcond);
  e = min_e;
  a = min_a;
  hh = min_h;
  s_pair = 0;
  int s_min_r = 0;
  pq = at(P.q_enc, P.n_qenc, bq);
  pd = at(P.db_seq, P.n_db, bd);
  tp = pair_type(t, pq, pd);
  iq = id = 0;
  acc_prev = at(P.db_acc, P.n_dacc, bb);
  qc = at(P.q_enc, P.n_qenc, bq + 1);
  dc = at(P.db_seq, P.n_db, bd + 1);
  xa = at(P.q_cond, P.n_qcond, ba + 1);
  xb = at(P.db_acc, P.n_dacc, bb - 1);
  xc = at(P.db_cond, P.n_dcond, bc - 1);
  for (int sn = 1;; ++sn) {
    if (sn > kSlack || qc < 2 || dc < 2) break;
    const int qc_n = at(P.q_enc, P.n_qenc, bq + sn + 1);
    const int dc_n = at(P.db_seq, P.n_db, bd + sn + 1);
    const float xa_n = at(P.q_cond, P.n_qcond, ba + sn + 1);
    const float xb_n = at(P.db_acc, P.n_dacc, bb - sn - 1);
    const float xc_n = at(P.db_cond, P.n_dcond, bc - sn - 1);
    const float dacc = ((xa + xb) - acc_prev) + xc;
    acc_prev = xb;
    e = e + dacc;
    a = a + dacc;
    const int u = sn - s_pair - 1;
    if (u == 0) {
      iq = qc;
      id = dc;
    }
    const int type = pair_type(t, qc, dc);
    const int type2 = rtype_of(t, type);
    const bool paired = type2 != 0;
    float le = 0.0f;
    if (paired) le = loop37(t, tp, type2, iq, id, pq, pd, u);
    e = e + le;
    hh = hh + le;
    if (paired && e < min_e) {
      min_e = e;
      min_a = a;
      min_h = hh;
      s_min_r = sn;
    }
    if (paired) {
      s_pair = sn;
      tp = type;
    }
    pq = qc;
    pd = dc;
    if (sn - s_min_r >= dropout) break;
    qc = qc_n;
    dc = dc_n;
    xa = xa_n;
    xb = xb_n;
    xc = xc_n;
  }
  const int64_t min_p = q_sp - s_min_l, min_q = db_sp - s_min_l;
  const int64_t min_r = k0 + s_min_r, min_ids = dbseq_start - s_min_r;
  const int64_t B = P.B;
  P.ints[h] = min_p;
  P.ints[B + h] = min_q;
  P.ints[2 * B + h] = min_r - min_p + 1;
  P.ints[3 * B + h] = min_ids;
  P.floats[h] = min_a;
  P.floats[B + h] = min_h;
  P.floats[2 * B + h] = min_e;
}

}  // namespace

// ptrs: q_enc, db_seq, q_acc, q_cond, db_acc, db_cond, q_sp, db_sp, length,
//   dbseq_start, qb, qab, dbb, aoff, coff, acc_e, hyb_e, bp, rtype, stack,
//   mism, intloop, i11, i21, i22, ints, floats (27 device pointers);
// sizes: n_qenc, n_db, n_qacc, n_qcond, n_dacc, n_dcond, B;
// iparams: d, dropout
extern "C" int ungapped_extend(void *const *ptrs, const long long *sizes,
                               const int *iparams, void *stream) {
  for (int k = 0; k < 7; ++k)  // the wrapper checks the same
    if (sizes[k] > kMaxSize || (k < 6 && sizes[k] < 1))
      return (int)cudaErrorInvalidValue;
  Params p;
  p.q_enc = (const int64_t *)ptrs[0];
  p.db_seq = (const int64_t *)ptrs[1];
  p.q_acc = (const float *)ptrs[2];
  p.q_cond = (const float *)ptrs[3];
  p.db_acc = (const float *)ptrs[4];
  p.db_cond = (const float *)ptrs[5];
  p.q_sp = (const int64_t *)ptrs[6];
  p.db_sp = (const int64_t *)ptrs[7];
  p.length = (const int64_t *)ptrs[8];
  p.dbseq_start = (const int64_t *)ptrs[9];
  p.qb = (const int64_t *)ptrs[10];
  p.qab = (const int64_t *)ptrs[11];
  p.dbb = (const int64_t *)ptrs[12];
  p.aoff = (const int64_t *)ptrs[13];
  p.coff = (const int64_t *)ptrs[14];
  p.acc_e = (const float *)ptrs[15];
  p.hyb_e = (const float *)ptrs[16];
  p.bp = (const int64_t *)ptrs[17];
  p.rtype = (const int64_t *)ptrs[18];
  p.stack = (const float *)ptrs[19];
  p.mism = (const float *)ptrs[20];
  p.intloop = (const float *)ptrs[21];
  p.i11 = (const float *)ptrs[22];
  p.i22 = (const float *)ptrs[24];  // ptrs[23], int21, is never read
  p.ints = (int64_t *)ptrs[25];
  p.floats = (float *)ptrs[26];
  p.n_qenc = (int)sizes[0];
  p.n_db = (int)sizes[1];
  p.n_qacc = (int)sizes[2];
  p.n_qcond = (int)sizes[3];
  p.n_dacc = (int)sizes[4];
  p.n_dcond = (int)sizes[5];
  p.B = sizes[6];
  p.d = iparams[0];
  p.dropout = iparams[1];
  if (p.B == 0) return 0;
  const int grid = (int)((p.B + kThreads - 1) / kThreads);
  ungapped_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
