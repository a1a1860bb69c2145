// The fused stage's expansion and threshold for Hopper (sm_90a): a thread
// per candidate pair, an order-preserving compaction without atomics, and
// the interaction-energy threshold packed into one buffer for one copy to
// the host.
//
// Replaces the XLA device programs of the JAX package's fused stage:
// priblast_tpu/search/fused.py:_expand_core (:102: pair generation, the
// suffix-array and position-map reads, the window accessibility, the
// interaction filter and its compaction) and _thresh_core (:245: the
// threshold and its compaction). Reference semantics:
// src/seed_search.cpp:47-151 and 274-301, src/rna_interaction_search.cpp:
// 389-391. The plain PyTorch versions, priblast_tpu_torch/search/fused.py:
// _expand_core and _thresh_core, are the kernels' twins: the same columns
// with the same bits, in the same order.
//
// Expansion, pair pid = o + t of a block of B pairs (a thread each):
// - ci = the upper bound of pid in the candidates' pair-count prefix cum,
//   minus 1 (a binary search: torch.searchsorted(cum, pid, right=True) - 1);
// - the candidate's row gives off = pid - cum[ci], ki = off / nq (db
//   position, outer), qi = off - ki nq (query position, inner);
// - q_sp = q_sa[row[QSA] + qi], db_sp = db_sa[row[DSA] + ki], and the four
//   position maps at pos = dbb + db_sp;
// - the two window sums in float64, each acc[abase] first and then
//   cond[cbase + t] one add at a time for d <= t < min(length, max_len):
//   _window's order and the native engine's (ops/native/search.cc:
//   174-179), so the sums equal native stage 1 bit for bit;
// - the filter acc_e + hyb_e < 0 in float64.
// Every buffer position is clamped to its buffer, as the plain version's
// _at clamps the window reads; the suffix-array and position-map reads,
// which the plain version indexes unclamped, are in range by construction
// and clamped here too, so no read leaves its buffer.
//
// Compaction, order-preserving and without atomics, in three launches:
// 1. count: a CTA walks tiles of blockDim.x pairs in a grid-stride loop
//    and writes each tile's survivors (a ballot per warp, the warps' counts
//    through shared memory), and a kept flag per pair;
// 2. scan: one CTA turns the tile counts into exclusive offsets in place
//    and writes the total after them;
// 3. scatter: the same tiles again; a kept pair's rank in its tile (the
//    same ballots) plus the tile's offset is its place, and its columns
//    are computed again and written there. Recomputing costs a second
//    pass over the pair's reads, but keeps the block's device memory at a
//    flag per pair and the survivors' columns (fused.PAIR_BYTES), where
//    staging the columns of every pair would take 104 bytes per pair.
// Counts are per tile, not per CTA: a grid-stride loop then keeps pair
// order whatever the grid, so a test can run a few CTAs of the same code.
//
// Threshold, on the ungapped kernel's output (n hits): count the tiles'
// hits with (double)energy <= threshold, scan them with the same scan
// launch, and scatter each kept hit's stream fields into one packed buffer
// laid out for the total read from the device: pid (int64) [n2], then
// q_sp, db_sp, q_len, db_len, dbseq_start, dbseq_id (int32) [6][n2], then
// acc_e, hyb_e, energy (float32) [3][n2]; 44 bytes per hit. The wrapper
// reads the total and copies those bytes to the host in one copy.
//
// Bound on this card: bytes. A pair reads its candidate's row, two
// suffix-array entries, four position-map entries and up to 32
// accessibility entries, and a survivor writes 104 bytes; neighbouring
// pairs share the candidate and most window entries, so the caches serve
// most reads. Build with -fmad=false and without fast-math, as the other
// kernels: no contraction in the float64 sums.
//
// C entry points (ctypes): fused_expand (phase 0: count and scan; phase 1:
// scatter) and fused_threshold (count, scan, scatter). Each launches on the
// given stream and returns cudaGetLastError(), or cudaErrorInvalidValue /
// cudaErrorInvalidConfiguration for sizes or geometries it does not take.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxBlock = 1 << 23;   // pairs of a block: 32-bit indices
constexpr int kScanThreads = 1024;  // the scan's one CTA
// candidate rows (search/fused.py: _R_QSA .. _R_NQ)
constexpr int kQsa = 0, kDsa = 1, kLen = 2, kQb = 3, kQab = 4, kDbb = 5,
              kNq = 6;
// the survivors' int64 rows, in the wrapper's order (ops/fused_expand.py:
// COLS), then acc_e, hyb_e as float64 rows
constexpr int kPid = 0, kQsp = 1, kDbsp = 2, kLength = 3, kSid = 4,
              kStart = 5, kOQb = 6, kOQab = 7, kODbb = 8, kAoff = 9,
              kCoff = 10;

struct ExpandParams {
  const int64_t *cum, *cand;  // [nc + 1], [7][nc]
  const double *energy;       // [nc]
  const int64_t *q_sa, *db_sa, *pos_sid, *pos_ls, *pos_aoff, *pos_coff;
  const float *q_acc, *q_cond, *db_acc, *db_cond;
  int64_t nc, n_qsa, n_dsa, n_pos, n_qacc, n_qcond, n_dacc, n_dcond;
  int64_t o;     // the block's first pair id
  int B;         // pairs of the block
  int d, max_len;
  unsigned char *keep;  // [B]
  int *counts;          // [tiles + 1]
  int64_t *ints;        // [11][n_out] (scatter only)
  double *floats;       // [2][n_out] (scatter only)
  int64_t n_out;
};

struct ScanParams {
  int *counts;  // [tiles + 1]: counts in, exclusive offsets and total out
  int tiles;
};

struct ThreshParams {
  const int64_t *q_sp, *db_sp, *q_len, *db_len, *start;  // [n] each
  const float *acc_e, *hyb_e, *energy;                   // [n] each
  const int64_t *sid, *pid;                              // [n] each
  int n;
  double threshold;
  int *counts;         // [tiles + 1]
  unsigned char *out;  // 44 bytes per kept hit (capacity n)
};

__device__ __forceinline__ int64_t clamp_pos(int64_t pos, int64_t n) {
  return pos < 0 ? 0 : (pos > n - 1 ? n - 1 : pos);
}

__device__ __forceinline__ int64_t ld(const int64_t *p) {
  return (int64_t)__ldg(reinterpret_cast<const long long *>(p));
}

// The rank of this thread's `keep` among the CTA's threads before it, and
// the CTA's count in *total. Every thread of the CTA calls it (it meets
// at __syncthreads); s_warps holds a count per warp.
__device__ int tile_rank(bool keep, int *s_warps, int *total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ball = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) s_warps[warp] = __popc(ball);
  __syncthreads();
  int before = 0, all = 0;
  const int warps = (blockDim.x + 31) >> 5;
  for (int k = 0; k < warps; ++k) {
    const int c = s_warps[k];
    if (k < warp) before += c;
    all += c;
  }
  __syncthreads();  // s_warps is written again for the next tile
  *total = all;
  return before + __popc(ball & ((1u << lane) - 1u));
}

// acc[abase] + cond[cbase + t] for d <= t < min(length, max_len), in
// float64, one add at a time (search/fused.py:_window)
__device__ double window(const float *acc, int64_t n_acc, const float *cond,
                         int64_t n_cond, int64_t abase, int64_t cbase,
                         int64_t length, int d, int max_len) {
  double w = (double)__ldg(acc + clamp_pos(abase, n_acc));
  const int64_t end = length < max_len ? length : (int64_t)max_len;
  for (int64_t t = d; t < end; ++t)
    w = w + (double)__ldg(cond + clamp_pos(cbase + t, n_cond));
  return w;
}

struct Pair {
  int64_t pid, q_sp, db_sp, length, sid, start, qb, qab, dbb, aoff, coff;
  double acc_e, hyb_e;
};

// pair t of the block: _expand_core's columns
__device__ Pair expand_pair(const ExpandParams &P, int t) {
  Pair r;
  r.pid = P.o + t;
  // the first prefix entry above pid, minus 1
  int64_t lo = 0, hi = P.nc + 1;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (ld(P.cum + mid) > r.pid)
      hi = mid;
    else
      lo = mid + 1;
  }
  const int64_t ci = clamp_pos(lo - 1, P.nc);
  const int64_t *row = P.cand + ci;
  const int64_t off = r.pid - ld(P.cum + ci);
  const int64_t nq = ld(row + kNq * P.nc);
  const int64_t ki = off / nq;  // off >= 0 and nq >= 1: the floor
  const int64_t qi = off - ki * nq;
  r.q_sp = ld(P.q_sa + clamp_pos(ld(row + kQsa * P.nc) + qi, P.n_qsa));
  r.db_sp = ld(P.db_sa + clamp_pos(ld(row + kDsa * P.nc) + ki, P.n_dsa));
  r.length = ld(row + kLen * P.nc);
  r.qb = ld(row + kQb * P.nc);
  r.qab = ld(row + kQab * P.nc);
  r.dbb = ld(row + kDbb * P.nc);
  const int64_t pos = clamp_pos(r.dbb + r.db_sp, P.n_pos);
  r.start = ld(P.pos_ls + pos) - r.db_sp - r.length;
  r.aoff = ld(P.pos_aoff + pos);
  r.coff = ld(P.pos_coff + pos);
  r.sid = ld(P.pos_sid + pos);
  const int64_t qs = r.qab + r.q_sp;
  r.acc_e = window(P.q_acc, P.n_qacc, P.q_cond, P.n_qcond, qs, qs, r.length,
                   P.d, P.max_len) +
            window(P.db_acc, P.n_dacc, P.db_cond, P.n_dcond,
                   r.aoff + r.start, r.coff + r.start, r.length, P.d,
                   P.max_len);
  r.hyb_e = __ldg(P.energy + ci);
  return r;
}

__global__ void expand_count_kernel(ExpandParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  int *s_warps = reinterpret_cast<int *>(smem);
  const int tiles = (P.B + blockDim.x - 1) / blockDim.x;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t = tile * blockDim.x + threadIdx.x;
    bool keep = false;
    if (t < P.B) {
      const Pair r = expand_pair(P, t);
      keep = r.acc_e + r.hyb_e < 0.0;
      P.keep[t] = keep;
    }
    int total;
    tile_rank(keep, s_warps, &total);
    if (threadIdx.x == 0) P.counts[tile] = total;
  }
}

__global__ void expand_scatter_kernel(ExpandParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  int *s_warps = reinterpret_cast<int *>(smem);
  const int tiles = (P.B + blockDim.x - 1) / blockDim.x;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t = tile * blockDim.x + threadIdx.x;
    const bool keep = t < P.B && P.keep[t] != 0;
    int total;
    const int rank = tile_rank(keep, s_warps, &total);
    if (keep) {
      const Pair r = expand_pair(P, t);
      const int64_t k = (int64_t)P.counts[tile] + rank, n = P.n_out;
      int64_t *o = P.ints + k;
      o[kPid * n] = r.pid;
      o[kQsp * n] = r.q_sp;
      o[kDbsp * n] = r.db_sp;
      o[kLength * n] = r.length;
      o[kSid * n] = r.sid;
      o[kStart * n] = r.start;
      o[kOQb * n] = r.qb;
      o[kOQab * n] = r.qab;
      o[kODbb * n] = r.dbb;
      o[kAoff * n] = r.aoff;
      o[kCoff * n] = r.coff;
      P.floats[k] = r.acc_e;
      P.floats[n + k] = r.hyb_e;
    }
  }
}

// One CTA: each thread sums a contiguous run of tiles, the runs' sums are
// scanned in shared memory (Hillis-Steele, two buffers), then each thread
// writes its run's exclusive offsets over the counts; the total goes after
// the last tile.
__global__ void scan_kernel(ScanParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  int *src = reinterpret_cast<int *>(smem), *dst = src + blockDim.x;
  const int T = blockDim.x, tid = threadIdx.x;
  const int per = (P.tiles + T - 1) / T;
  const int lo = tid * per < P.tiles ? tid * per : P.tiles;
  const int hi = lo + per < P.tiles ? lo + per : P.tiles;
  int sum = 0;
  for (int k = lo; k < hi; ++k) sum += P.counts[k];
  src[tid] = sum;
  __syncthreads();
  for (int off = 1; off < T; off <<= 1) {
    dst[tid] = tid >= off ? src[tid] + src[tid - off] : src[tid];
    __syncthreads();
    int *tmp = src;
    src = dst;
    dst = tmp;
  }
  int at = src[tid] - sum;
  for (int k = lo; k < hi; ++k) {
    const int c = P.counts[k];
    P.counts[k] = at;
    at += c;
  }
  if (tid == T - 1) P.counts[P.tiles] = src[T - 1];
}

__global__ void thresh_count_kernel(ThreshParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  int *s_warps = reinterpret_cast<int *>(smem);
  const int tiles = (P.n + blockDim.x - 1) / blockDim.x;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t = tile * blockDim.x + threadIdx.x;
    const bool keep = t < P.n && (double)P.energy[t] <= P.threshold;
    int total;
    tile_rank(keep, s_warps, &total);
    if (threadIdx.x == 0) P.counts[tile] = total;
  }
}

__global__ void thresh_scatter_kernel(ThreshParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  int *s_warps = reinterpret_cast<int *>(smem);
  const int tiles = (P.n + blockDim.x - 1) / blockDim.x;
  const int64_t n2 = P.counts[tiles];
  int64_t *pid = reinterpret_cast<int64_t *>(P.out);
  int32_t *ints = reinterpret_cast<int32_t *>(P.out + 8 * n2);
  float *floats = reinterpret_cast<float *>(P.out + 32 * n2);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t = tile * blockDim.x + threadIdx.x;
    const bool keep = t < P.n && (double)P.energy[t] <= P.threshold;
    int total;
    const int rank = tile_rank(keep, s_warps, &total);
    if (keep) {
      const int64_t k = (int64_t)P.counts[tile] + rank;
      pid[k] = P.pid[t];
      // int64 -> int32 as numpy's astype: the low 32 bits
      ints[k] = (int32_t)P.q_sp[t];
      ints[n2 + k] = (int32_t)P.db_sp[t];
      ints[2 * n2 + k] = (int32_t)P.q_len[t];
      ints[3 * n2 + k] = (int32_t)P.db_len[t];
      ints[4 * n2 + k] = (int32_t)P.start[t];
      ints[5 * n2 + k] = (int32_t)P.sid[t];
      floats[k] = P.acc_e[t];
      floats[n2 + k] = P.hyb_e[t];
      floats[2 * n2 + k] = P.energy[t];
    }
  }
}

// one launch of `kern`; the only launch site of this file
template <typename P>
int run(void (*kern)(P), long long grid, int threads, size_t bytes,
        void *stream, const P &p) {
  if (grid < 1 || grid > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  kern<<<(int)grid, threads, bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

bool bad_threads(long long threads) {
  return threads < 32 || threads > 1024 || threads % 32 != 0;
}

// CTAs of a grid-stride launch over `tiles` tiles: `grid`, or one per tile
// where it is 0
long long ctas(long long tiles, long long grid) {
  return grid > 0 && grid < tiles ? grid : tiles;
}

int scan(int *counts, long long tiles, void *stream) {
  ScanParams s;
  s.counts = counts;
  s.tiles = (int)tiles;
  return run(scan_kernel, 1, kScanThreads,
             2 * kScanThreads * sizeof(int), stream, s);
}

}  // namespace

// ptrs: cum, cand, energy, q_sa, db_sa, pos_sid, pos_ls, pos_aoff,
//   pos_coff, q_acc, q_cond, db_acc, db_cond, keep, counts, ints, floats
//   (17 device pointers; the last two only for phase 1);
// sizes: nc, n_qsa, n_dsa, n_pos, n_qacc, n_qcond, n_dacc, n_dcond, o, B,
//   d, max_len, threads per CTA (a multiple of 32), CTAs (0: one per
//   tile), phase (0: count and scan; 1: scatter), n_out (phase 1: the
//   total the scan wrote);
// scalars: unused.
extern "C" int fused_expand(void *const *ptrs, const long long *sizes,
                            const double *, void *stream) {
  ExpandParams p;
  p.cum = (const int64_t *)ptrs[0];
  p.cand = (const int64_t *)ptrs[1];
  p.energy = (const double *)ptrs[2];
  p.q_sa = (const int64_t *)ptrs[3];
  p.db_sa = (const int64_t *)ptrs[4];
  p.pos_sid = (const int64_t *)ptrs[5];
  p.pos_ls = (const int64_t *)ptrs[6];
  p.pos_aoff = (const int64_t *)ptrs[7];
  p.pos_coff = (const int64_t *)ptrs[8];
  p.q_acc = (const float *)ptrs[9];
  p.q_cond = (const float *)ptrs[10];
  p.db_acc = (const float *)ptrs[11];
  p.db_cond = (const float *)ptrs[12];
  p.keep = (unsigned char *)ptrs[13];
  p.counts = (int *)ptrs[14];
  p.ints = (int64_t *)ptrs[15];
  p.floats = (double *)ptrs[16];
  p.nc = sizes[0];
  p.n_qsa = sizes[1];
  p.n_dsa = sizes[2];
  p.n_pos = sizes[3];
  p.n_qacc = sizes[4];
  p.n_qcond = sizes[5];
  p.n_dacc = sizes[6];
  p.n_dcond = sizes[7];
  p.o = sizes[8];
  const long long B = sizes[9];
  p.d = (int)sizes[10];
  p.max_len = (int)sizes[11];
  const long long threads = sizes[12], grid = sizes[13], phase = sizes[14];
  p.n_out = sizes[15];
  if (B == 0) return 0;
  if (B < 0 || B > kMaxBlock || p.o < 0 || p.n_out < 0 || p.n_out > B)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 8; ++k)  // the wrapper checks the same
    if (sizes[k] < 1) return (int)cudaErrorInvalidValue;
  if (bad_threads(threads) || grid < 0) return (int)cudaErrorInvalidConfiguration;
  p.B = (int)B;
  const long long tiles = (B + threads - 1) / threads;
  const size_t bytes = (size_t)(threads / 32) * sizeof(int);
  if (phase == 0) {
    const int err = run(expand_count_kernel, ctas(tiles, grid), (int)threads,
                        bytes, stream, p);
    return err != 0 ? err : scan(p.counts, tiles, stream);
  }
  if (p.n_out == 0) return 0;
  return run(expand_scatter_kernel, ctas(tiles, grid), (int)threads, bytes,
             stream, p);
}

// ptrs: q_sp, db_sp, q_len, db_len, dbseq_start (int64), acc_e, hyb_e,
//   energy (float32) of the ungapped output, dbseq_id, pid (int64) of its
//   hits, counts (int32, tiles + 1), out (44 bytes per hit) (12 device
//   pointers);
// sizes: n, threads per CTA (a multiple of 32), CTAs (0: one per tile);
// scalars: the interaction-energy threshold.
extern "C" int fused_threshold(void *const *ptrs, const long long *sizes,
                               const double *scalars, void *stream) {
  ThreshParams p;
  p.q_sp = (const int64_t *)ptrs[0];
  p.db_sp = (const int64_t *)ptrs[1];
  p.q_len = (const int64_t *)ptrs[2];
  p.db_len = (const int64_t *)ptrs[3];
  p.start = (const int64_t *)ptrs[4];
  p.acc_e = (const float *)ptrs[5];
  p.hyb_e = (const float *)ptrs[6];
  p.energy = (const float *)ptrs[7];
  p.sid = (const int64_t *)ptrs[8];
  p.pid = (const int64_t *)ptrs[9];
  p.counts = (int *)ptrs[10];
  p.out = (unsigned char *)ptrs[11];
  const long long n = sizes[0], threads = sizes[1], grid = sizes[2];
  p.threshold = scalars[0];
  if (n == 0) return 0;
  if (n < 0 || n > kMaxBlock) return (int)cudaErrorInvalidValue;
  if (bad_threads(threads) || grid < 0) return (int)cudaErrorInvalidConfiguration;
  p.n = (int)n;
  const long long tiles = (n + threads - 1) / threads;
  const size_t bytes = (size_t)(threads / 32) * sizeof(int);
  int err = run(thresh_count_kernel, ctas(tiles, grid), (int)threads, bytes,
                stream, p);
  if (err == 0) err = scan(p.counts, tiles, stream);
  if (err == 0)
    err = run(thresh_scatter_kernel, ctas(tiles, grid), (int)threads, bytes,
              stream, p);
  return err;
}
