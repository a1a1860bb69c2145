// Ungapped extension for Hopper (sm_90a): one thread per hit, each hit run
// to its own stop.
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
// version's masked "+ 0" adds are kept (-0.0f + 0.0f is +0.0f). Every
// buffer position is clamped to its buffer, as the plain version's `_at`
// does, and every table index to its table, as `_take` does; a table is
// read only where its value is used.
//
// Per hit: the left phase steps from (q_sp, db_sp) down until a blocked
// character, a buffer edge or the dropout; then the right phase steps from
// the seed's end up. A step adds the accessibility increment, the loop
// energy of a paired step (looked up from the characters in the Turner
// tables) and keeps the running minimum with its argmin (strict <).
//
// Mapping: one thread per hit, kThreads threads per block. The block
// stages the small tables (BP_pair, rtype, stack37, mismatchI37,
// internal_loop37: 1,148 bytes) in shared memory; int11, int21 and int22
// are read through the read-only cache (__ldg). A warp runs as long as its
// slowest hit.
//
// Bound on this card: a step reads two characters (int64) and four
// accessibility entries (float32) at positions that follow the hit, and
// does ~40 integer and float operations. The steps of one hit are a chain
// of dependent loads, so the kernel depends on many threads in flight to
// hide their latency.
//
// C entry point (ctypes): ungapped_extend. It launches on the given stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// table sizes (entries) and the shared-memory layout of the small ones
constexpr int kNBp = 25, kNRt = 7, kNStack = 49, kNMism = 175,
              kNIntloop = 31, kNI11 = 1600, kNI21 = 8000, kNI22 = 40000;
constexpr int kSmemBytes =
    4 * (kNBp + kNRt + kNStack + kNMism + kNIntloop);

struct Params {
  const int64_t *q_enc, *db_seq;
  const float *q_acc, *q_cond, *db_acc, *db_cond;
  const int64_t *q_sp, *db_sp, *length, *dbseq_start, *qb, *qab, *dbb,
      *aoff, *coff;
  const float *acc_e, *hyb_e;
  const int64_t *bp, *rtype;
  const float *stack, *mism, *intloop, *i11, *i21, *i22;
  int64_t *ints;   // [4, B]: q_sp, db_sp, new length (q_len = db_len),
                   //         dbseq_start
  float *floats;   // [3, B]: acc_e, hyb_e, energy
  int64_t n_qenc, n_db, n_qacc, n_qcond, n_dacc, n_dcond, B;
  int d, dropout;
};

struct Tables {
  const int *bp, *rt;
  const float *stack, *mism, *intloop, *i11, *i21, *i22;
};

__device__ __forceinline__ int64_t clamp_pos(int64_t pos, int64_t n) {
  return pos < 0 ? 0 : (pos > n - 1 ? n - 1 : pos);
}

__device__ __forceinline__ int64_t at(const int64_t *buf, int64_t n,
                                      int64_t pos) {
  return (int64_t)__ldg(reinterpret_cast<const long long *>(buf)
                        + clamp_pos(pos, n));
}

__device__ __forceinline__ float at(const float *buf, int64_t n,
                                    int64_t pos) {
  return __ldg(buf + clamp_pos(pos, n));
}

__device__ __forceinline__ int64_t mapc(int64_t v) {
  // encoded char -> energy index (2..5 -> 1..4; soft-masked 6..9 -> 1..4)
  return v <= 5 ? v - 1 : v - 5;
}

__device__ __forceinline__ int pair_type(const Tables &t, int64_t qc,
                                         int64_t dc) {
  return t.bp[clamp_pos(mapc(qc) * 5 + mapc(dc), kNBp)];
}

__device__ __forceinline__ int rtype_of(const Tables &t, int type) {
  return t.rt[clamp_pos(type, kNRt)];
}

// Hybridization loop energy / 100, no-bulge variant (reference:
// src/ungapped_extension.cpp:157-186); fi/fj/fp/fq are flat buffer
// positions of the outer (i, j) and inner (p, q) pairs.
__device__ float loop37(const Params &P, const Tables &t, int type1,
                        int type2, int64_t fi, int64_t fj, int64_t fp,
                        int64_t fq, int64_t u1, int64_t u2) {
  float z;
  if (u1 == 0 && u2 == 0) {
    z = t.stack[clamp_pos(type1 * 7 + type2, kNStack)];
  } else {
    const int64_t a = mapc(at(P.q_enc, P.n_qenc, fi + 1));
    const int64_t b = mapc(at(P.db_seq, P.n_db, fj + 1));
    const int64_t c = mapc(at(P.q_enc, P.n_qenc, fp - 1));
    const int64_t dch = mapc(at(P.db_seq, P.n_db, fq - 1));
    const int64_t t12 = type1 * 8 + type2;
    if (u1 + u2 == 2) {
      z = __ldg(t.i11 + clamp_pos((t12 * 5 + a) * 5 + b, kNI11));
    } else if (u1 == 1 && u2 == 2) {
      z = __ldg(t.i21 + clamp_pos(((t12 * 5 + a) * 5 + dch) * 5 + b, kNI21));
    } else if (u1 == 2 && u2 == 1) {
      z = __ldg(t.i21 + clamp_pos((((type2 * 8 + type1) * 5 + dch) * 5 + a)
                                      * 5 + c, kNI21));
    } else if (u1 == 2 && u2 == 2) {
      z = __ldg(t.i22 + clamp_pos((((t12 * 5 + a) * 5 + c) * 5 + dch) * 5 + b,
                                  kNI22));
    } else {
      const int64_t u = u1 + u2;
      z = t.intloop[u < 0 ? 0 : (u > 30 ? 30 : u)]
          + t.mism[clamp_pos((type1 * 5 + a) * 5 + b, kNMism)];
      z = z + t.mism[clamp_pos((type2 * 5 + dch) * 5 + c, kNMism)];
    }
  }
  return z / 100.0f;
}

__global__ void ungapped_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  int *s_bp = reinterpret_cast<int *>(smem);
  int *s_rt = s_bp + kNBp;
  float *s_stack = reinterpret_cast<float *>(s_rt + kNRt);
  float *s_mism = s_stack + kNStack;
  float *s_intloop = s_mism + kNMism;
  for (int k = threadIdx.x; k < kNBp; k += blockDim.x)
    s_bp[k] = (int)P.bp[k];
  for (int k = threadIdx.x; k < kNRt; k += blockDim.x)
    s_rt[k] = (int)P.rtype[k];
  for (int k = threadIdx.x; k < kNStack; k += blockDim.x)
    s_stack[k] = P.stack[k];
  for (int k = threadIdx.x; k < kNMism; k += blockDim.x)
    s_mism[k] = P.mism[k];
  for (int k = threadIdx.x; k < kNIntloop; k += blockDim.x)
    s_intloop[k] = P.intloop[k];
  __syncthreads();
  const Tables t{s_bp, s_rt, s_stack, s_mism, s_intloop, P.i11, P.i21, P.i22};

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
  int64_t i = q_sp, j = db_sp, id_end = dbseq_start + length - 1;
  int64_t p = q_sp, q = db_sp;
  float e = energy0, a = acc0, hh = hyb0;
  float min_e = energy0, min_a = acc0, min_h = hyb0;
  int64_t min_p = q_sp, min_q = db_sp;
  for (;;) {
    const int64_t i_n = i - 1, j_n = j - 1, id_n = id_end + 1;
    const int64_t qc = at(P.q_enc, P.n_qenc, qb + i_n);
    const int64_t dc = at(P.db_seq, P.n_db, dbb + j_n);
    if (i_n < 0 || j_n < 0 || qc < 2 || dc < 2) break;
    const float dacc = ((at(P.q_acc, P.n_qacc, qab + i_n)
                         - at(P.q_acc, P.n_qacc, qab + i_n + 1))
                        + at(P.q_cond, P.n_qcond, qab + i_n + d))
                       + at(P.db_cond, P.n_dcond, coff + id_n);
    e = e + dacc;
    a = a + dacc;
    const int type1 = pair_type(t, qc, dc);
    const bool paired = type1 != 0;
    float le = 0.0f;
    if (paired) {
      const int type2 = rtype_of(
          t, pair_type(t, at(P.q_enc, P.n_qenc, qb + p),
                       at(P.db_seq, P.n_db, dbb + q)));
      le = loop37(P, t, type1, type2, qb + i_n, dbb + j_n, qb + p, dbb + q,
                  p - i_n - 1, q - j_n - 1);
    }
    e = e + le;
    hh = hh + le;
    if (paired && e < min_e) {
      min_e = e;
      min_a = a;
      min_h = hh;
      min_p = i_n;
      min_q = j_n;
    }
    if (paired) {
      p = i_n;
      q = j_n;
    }
    i = i_n;
    j = j_n;
    id_end = id_n;
    if (min_p - i_n >= dropout) break;
  }

  // ---- right phase (reference :96-145) ----
  int64_t k = q_sp + length - 1, l = db_sp + length - 1, ids = dbseq_start;
  int64_t r = k, s = l;
  e = min_e;
  a = min_a;
  hh = min_h;
  int64_t min_r = k, min_ids = dbseq_start;
  for (;;) {
    const int64_t k_n = k + 1, l_n = l + 1, ids_n = ids - 1;
    const int64_t qc = at(P.q_enc, P.n_qenc, qb + k_n);
    const int64_t dc = at(P.db_seq, P.n_db, dbb + l_n);
    if (qc < 2 || dc < 2) break;
    const float dacc = ((at(P.q_cond, P.n_qcond, qab + k_n)
                         + at(P.db_acc, P.n_dacc, aoff + ids_n))
                        - at(P.db_acc, P.n_dacc, aoff + ids_n + 1))
                       + at(P.db_cond, P.n_dcond, coff + ids_n + d);
    e = e + dacc;
    a = a + dacc;
    const int type2 = rtype_of(t, pair_type(t, qc, dc));
    const bool paired = type2 != 0;
    float le = 0.0f;
    if (paired) {
      const int type1 = pair_type(t, at(P.q_enc, P.n_qenc, qb + r),
                                  at(P.db_seq, P.n_db, dbb + s));
      le = loop37(P, t, type1, type2, qb + r, dbb + s, qb + k_n, dbb + l_n,
                  k_n - r - 1, l_n - s - 1);
    }
    e = e + le;
    hh = hh + le;
    if (paired && e < min_e) {
      min_e = e;
      min_a = a;
      min_h = hh;
      min_r = k_n;
      min_ids = ids_n;
    }
    if (paired) {
      r = k_n;
      s = l_n;
    }
    k = k_n;
    l = l_n;
    ids = ids_n;
    if (k_n - min_r >= dropout) break;
  }

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
  p.i21 = (const float *)ptrs[23];
  p.i22 = (const float *)ptrs[24];
  p.ints = (int64_t *)ptrs[25];
  p.floats = (float *)ptrs[26];
  p.n_qenc = sizes[0];
  p.n_db = sizes[1];
  p.n_qacc = sizes[2];
  p.n_qcond = sizes[3];
  p.n_dacc = sizes[4];
  p.n_dcond = sizes[5];
  p.B = sizes[6];
  p.d = iparams[0];
  p.dropout = iparams[1];
  if (p.B == 0) return 0;
  const int64_t blocks = (p.B + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const int grid = (int)blocks;
  ungapped_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
