// The fused stage's expansion and threshold for Hopper (sm_90a): a thread
// per candidate pair (or hit), each block's compaction in one launch with a
// single-pass decoupled look-back, and the threshold's records laid out for
// one copy to the host.
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
//   minus 1 (torch.searchsorted(cum, pid, right=True) - 1). A tile's
//   pairs are consecutive, so its candidates are too: one warp finds the
//   tile's first and last candidate by a 32-ary search (each lane probes
//   one point of the range a step), the tile's slice of cum, at most tile +
//   1 entries, is staged in shared memory, and each thread searches that
//   slice (the GPU form of the JAX package's segment broadcast, _seg_i32);
// - the candidate's row gives off = pid - cum[ci], ki = off / nq (db
//   position, outer), qi = off - ki nq (query position, inner);
// - q_sp = q_sa[row[QSA] + qi], db_sp = db_sa[row[DSA] + ki], and the four
//   position maps at pos = dbb + db_sp;
// - the two window sums in float64, each acc[abase] first and then
//   cond[cbase + t] one add at a time for d <= t < min(length, max_len):
//   _window's order and the native engine's (ops/native/search.cc:
//   174-179), so the sums equal native stage 1 bit for bit; a window's
//   cond entries are all loaded before its add chain starts;
// - the filter acc_e + hyb_e < 0 in float64.
// Every buffer position is clamped to its buffer, as the plain version's
// _at clamps the window reads; the suffix-array and position-map reads,
// which the plain version indexes unclamped, are in range by construction
// and clamped here too, so no read leaves its buffer.
//
// Compaction in one pass, order-preserving (Merrill & Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", NVIDIA NVR-2016-002): a
// CTA takes tiles of blockDim.x items in order from a counter in device
// memory (one atomicAdd a tile), so a tile waits only on tiles that running
// CTAs have taken, and the wait ends. A tile computes its items once, ranks
// its kept ones by ballots (tile_rank), stages them in shared memory in
// rank order and publishes its count at once. The CTA then computes its
// next tile, and only then looks back for the held tile: over its
// predecessors' published counts and inclusive prefixes, 32 at a time,
// until it meets an inclusive prefix; it publishes the held tile's own and
// writes its staged items at prefix + rank, each column as a contiguous
// run. A count is published before any wait, so every wait ends; holding a
// tile over the next one's compute hides the look-back's latency. The
// launch holds as many CTAs as the card runs at once (persistent). A state
// word holds a flag and a value, written by one 64-bit store and read by
// one 64-bit load (publish, peek); no other data rides on it, so no fence
// orders it. An item's place depends only on tile and item ids, never on
// scheduling: the output is deterministic. The last tile writes the total after the tile states.
// The outputs are sized for every item (the block's or the hits' count),
// since the total is known only when the launch ends.
//
// Threshold, on the ungapped kernel's output (n hits): the same pass with
// keep = (double)energy <= threshold, each hit's energy read once; a tile
// stages its kept hits' records in shared memory in rank order, then
// stores them as whole runs, one field at a time. The records, for a capacity of n hits: pid (int64) [n],
// then q_sp, db_sp, q_len, db_len, dbseq_start, dbseq_id (int32) [6][n],
// then acc_e, hyb_e, energy (float32) [3][n], the first n2 of each row
// kept. fused_records_to_host copies a run of the kept records into a
// host buffer laid out the same way for its own capacity, with three
// copies (pid, the int32 rows, the float32 rows).
//
// Bound on this card: bytes. A pair reads its candidate's row, two
// suffix-array entries, four position-map entries and up to 32
// accessibility entries, and a survivor writes 104 bytes; neighbouring
// pairs share the candidate and most window entries, so the caches serve
// most reads. Build with -fmad=false and without fast-math, as the other
// kernels: no contraction in the float64 sums.
//
// C entry points (ctypes): fused_expand, fused_threshold (a memset of the
// scratch and one launch each), fused_records_to_host (the copies) and
// fused_copy_stream (the copies' stream). Each works on the given stream
// and returns cudaGetLastError() (the copies: their own status), or
// cudaErrorInvalidValue / cudaErrorInvalidConfiguration for sizes or
// geometries it does not take.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxBlock = 1 << 23;  // items of a launch: 32-bit indices
constexpr int kWin = 16;  // cond entries a window loads before its adds
// candidate rows (search/fused.py: _R_QSA .. _R_NQ)
constexpr int kQsa = 0, kDsa = 1, kLen = 2, kQb = 3, kQab = 4, kDbb = 5,
              kNq = 6;
// the survivors' int64 rows, in the wrapper's order (ops/fused_expand.py:
// COLS), then acc_e, hyb_e as float64 rows
constexpr int kPid = 0, kQsp = 1, kDbsp = 2, kLength = 3, kSid = 4,
              kStart = 5, kOQb = 6, kOQab = 7, kODbb = 8, kAoff = 9,
              kCoff = 10;
// a tile state word: flag << 32 | value; X (0): nothing published yet
constexpr unsigned long long kAggregate = 1ull << 32;  // value: the count
constexpr unsigned long long kPrefix = 2ull << 32;     // inclusive prefix
// the launch's scratch, int64 words zeroed before it (clear): the tile
// counter, the total, then a state per tile
constexpr int kCounter = 0, kTotal = 1, kStates = 2;

struct ExpandParams {
  const int64_t *cum, *cand;  // [nc + 1], [7][nc]
  const double *energy;       // [nc]
  const int64_t *q_sa, *db_sa, *pos_sid, *pos_ls, *pos_aoff, *pos_coff;
  const float *q_acc, *q_cond, *db_acc, *db_cond;
  int64_t nc, n_qsa, n_dsa, n_pos, n_qacc, n_qcond, n_dacc, n_dcond;
  int64_t o;   // the block's first pair id
  int B;       // pairs of the block: the outputs' capacity
  int d, max_len;
  unsigned long long *scratch;  // [kStates + tiles]
  int64_t *ints;                // [11][B]
  double *floats;               // [2][B]
};

struct ThreshParams {
  const int64_t *q_sp, *db_sp, *q_len, *db_len, *start;  // [n] each
  const float *acc_e, *hyb_e, *energy;                   // [n] each
  const int64_t *sid, *pid;                              // [n] each
  int n;  // hits: the records' capacity
  double threshold;
  unsigned long long *scratch;  // [kStates + tiles]
  unsigned char *out;           // 44 bytes per hit, laid out for n
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

// One 64-bit store of a tile state word, read by peek as one 64-bit load.
// The word carries all that is published through it (the flag and its
// value), and nothing else is read on the strength of it, so neither
// needs a fence: a fence before the store waits for this thread's earlier
// output writes, which cost 16% of the expansion's time and 21% of the
// threshold's on the H100 (fused_ab.py; PERF.md).
__device__ __forceinline__ void publish(unsigned long long *word,
                                        unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long *>(word) = v;
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long *word) {
  return *reinterpret_cast<const volatile unsigned long long *>(word);
}

// The next tile of this CTA, in order over the launch (the CTA's threads
// all call it; s_tile is a shared slot).
__device__ int next_tile(unsigned long long *scratch, int *s_tile) {
  __syncthreads();  // every thread has read the previous tile's slot
  if (threadIdx.x == 0)
    *s_tile = (int)atomicAdd(scratch + kCounter, 1ull);
  __syncthreads();
  return *s_tile;
}

// Publish tile `tile`'s count (tile 0: its inclusive prefix), as soon as
// the tile is counted; one thread calls it.
__device__ __forceinline__ void publish_count(unsigned long long *scratch,
                                              int tile, unsigned count) {
  publish(scratch + kStates + tile,
          (tile == 0 ? kPrefix : kAggregate) | count);
}

// The exclusive prefix of tile `tile`, whose count `count` is published,
// from the tile states; warp 0 calls it and every lane gets the prefix.
// Reads the predecessors 32 at a time, lane k the (k + 1)-th nearest, each
// lane waiting until its word holds a flag, adds the counts up to the
// nearest inclusive prefix, and publishes this tile's inclusive prefix;
// the last tile also writes the total.
__device__ unsigned look_back(unsigned long long *scratch, int tile,
                              int tiles, unsigned count) {
  const unsigned long long *states = scratch + kStates;
  const int lane = threadIdx.x & 31;
  unsigned excl = 0;
  for (int base = tile - 1; base >= 0; base -= 32) {
    const int j = base - lane;
    unsigned long long s = kPrefix;  // before tile 0: a prefix of 0
    if (j >= 0) {
      s = peek(states + j);
      while ((s >> 32) == 0) {
        __nanosleep(32);
        s = peek(states + j);
      }
    }
    const unsigned prefixes = __ballot_sync(0xffffffffu, (s >> 32) == 2);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    unsigned v = lane <= stop ? (unsigned)s : 0u;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    excl += v;
    if (prefixes) break;
  }
  if (lane == 0 && tile > 0)
    publish(scratch + kStates + tile, kPrefix | (excl + count));
  if (lane == 0 && tile == tiles - 1)
    scratch[kTotal] = (unsigned long long)(excl + count);
  return excl;
}

// The exclusive prefix of a counted tile for every thread of the CTA: warp
// 0 looks back, the others wait at the barrier (s_prefix is a shared
// slot).
__device__ unsigned tile_prefix(unsigned long long *scratch, int tile,
                                int tiles, int count, unsigned *s_prefix) {
  if (threadIdx.x < 32) {
    const unsigned excl = look_back(scratch, tile, tiles, (unsigned)count);
    if (threadIdx.x == 0) *s_prefix = excl;
  }
  __syncthreads();
  return *s_prefix;
}

// ci with cum[ci] <= x < cum[ci + 1], for 0 <= ci < n and cum[0] <= x <
// cum[n], by one warp (every lane calls it; every lane gets ci): each step
// lane k >= 1 probes lo + k * step, and the probes at or below x, a prefix
// of the lanes, narrow [lo, hi] to one step.
__device__ int64_t warp_find(const int64_t *cum, int64_t n, int64_t x) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = n;  // cum[lo] <= x < cum[hi]
  while (hi - lo > 1) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t probe = lo + lane * step;
    const bool at_or_below = lane > 0 && probe < hi && ld(cum + probe) <= x;
    const int k = __popc(__ballot_sync(0xffffffffu, at_or_below));
    const int64_t next = lo + (int64_t)(k + 1) * step;
    lo += (int64_t)k * step;
    hi = next < hi ? next : hi;
  }
  return lo;
}

// acc[abase] + cond[cbase + t] for d <= t < min(length, max_len), in
// float64, one add at a time (search/fused.py:_window); the cond entries
// are loaded first, kWin at a time
__device__ double window(const float *acc, int64_t n_acc, const float *cond,
                         int64_t n_cond, int64_t abase, int64_t cbase,
                         int64_t length, int d, int max_len) {
  double w = (double)__ldg(acc + clamp_pos(abase, n_acc));
  const int64_t end = length < max_len ? length : (int64_t)max_len;
  for (int64_t t0 = d; t0 < end; t0 += kWin) {
    float v[kWin];
#pragma unroll
    for (int k = 0; k < kWin; ++k)
      if (t0 + k < end) v[k] = __ldg(cond + clamp_pos(cbase + t0 + k, n_cond));
#pragma unroll
    for (int k = 0; k < kWin; ++k)
      if (t0 + k < end) w = w + (double)v[k];
  }
  return w;
}

struct Pair {
  int64_t pid, q_sp, db_sp, length, sid, start, qb, qab, dbb, aoff, coff;
  double acc_e, hyb_e;
};

// pair t of the block, of candidate ci: _expand_core's columns
__device__ Pair expand_pair(const ExpandParams &P, int t, int64_t ci,
                            int64_t cum_ci) {
  Pair r;
  r.pid = P.o + t;
  const int64_t *row = P.cand + ci;
  const int64_t off = r.pid - cum_ci;
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

// shared memory: the warps' counts, the tile and prefix slots, the first
// and last candidate, then the tile's slice of cum (blockDim.x + 1), then
// two buffers of staged survivors, each 13 columns of blockDim.x (the 11
// int64 columns, then acc_e and hyb_e as float64 bits)
struct ExpandShared {
  int warps[32];
  int tile;
  unsigned prefix;
  long long first, last;
};
constexpr int kCols = 13;

// A held tile's staged survivors (`count` of them, in rank order) to the
// outputs at its prefix, each column a contiguous run (every thread of
// the CTA calls it).
__device__ void expand_write(const ExpandParams &P, int tile, int tiles,
                             int count, const int64_t *stage,
                             ExpandShared *sh) {
  const int T = blockDim.x;
  const int64_t excl = tile_prefix(P.scratch, tile, tiles, count,
                                   &sh->prefix);
  const int64_t n = P.B;
  for (int k = threadIdx.x; k < count; k += T) {
    for (int c = 0; c < kCols - 2; ++c)
      P.ints[c * n + excl + k] = stage[c * T + k];
    P.floats[excl + k] = __longlong_as_double(stage[(kCols - 2) * T + k]);
    P.floats[n + excl + k] = __longlong_as_double(stage[(kCols - 1) * T + k]);
  }
}

// A CTA takes tiles in turn; a tile's survivors are staged in shared
// memory and its count published at once, and they are written only after
// the CTA has computed its next tile (or run out of tiles), so its look-back
// usually finds the predecessors' counts already there. At most 64
// registers (one CTA of 1024 threads fits): more CTAs an SM hide more of
// the pairs' dependent loads (unbounded, 80 registers and 12% slower at
// 128 threads; fused_ab.py).
__global__ void __launch_bounds__(1024, 1) expand_kernel(ExpandParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  ExpandShared *sh = reinterpret_cast<ExpandShared *>(smem);
  const int T = blockDim.x, warp = threadIdx.x >> 5, warps = (T + 31) >> 5;
  int64_t *s_cum = reinterpret_cast<int64_t *>(smem + sizeof(ExpandShared));
  int64_t *s_stage = s_cum + T + 1;  // [2][kCols][T]
  const int tiles = (P.B + T - 1) / T;
  int held = -1, held_count = 0, buf = 0;
  for (int tile = next_tile(P.scratch, &sh->tile); tile < tiles;
       tile = next_tile(P.scratch, &sh->tile)) {
    const int t0 = tile * T;
    const int t1 = t0 + T < P.B ? t0 + T : P.B;  // past the tile's last
    // the tile's first and last candidate: warp 0 and warp 1 (one warp:
    // both)
    for (int k = warp; k < 2; k += warps) {
      const int64_t c = warp_find(P.cum, P.nc, P.o + (k ? t1 - 1 : t0));
      if ((threadIdx.x & 31) == 0) (k ? sh->last : sh->first) = c;
    }
    __syncthreads();
    const int64_t first = sh->first, n_slice = sh->last - first + 2;
    // candidates of no pair could make the slice longer than the tile:
    // then each thread searches cum in device memory
    const bool staged = n_slice <= T + 1;
    if (staged)
      for (int k = threadIdx.x; k < n_slice; k += T)
        s_cum[k] = ld(P.cum + first + k);
    __syncthreads();
    const int t = t0 + threadIdx.x;
    bool keep = false;
    Pair r;
    if (t < P.B) {
      const int64_t pid = P.o + t;
      int64_t lo = 0, hi = n_slice - 1;  // s_cum[lo] <= pid < s_cum[hi]
      if (staged) {
        while (hi - lo > 1) {
          const int64_t mid = (lo + hi) >> 1;
          if (s_cum[mid] > pid)
            hi = mid;
          else
            lo = mid;
        }
      } else {
        hi = P.nc;
        lo = 0;
        while (hi - lo > 1) {
          const int64_t mid = (lo + hi) >> 1;
          if (ld(P.cum + mid) > pid)
            hi = mid;
          else
            lo = mid;
        }
      }
      const int64_t ci = staged ? first + lo : lo;
      r = expand_pair(P, t, ci, staged ? s_cum[lo] : ld(P.cum + ci));
      keep = r.acc_e + r.hyb_e < 0.0;
    }
    int count;
    const int rank = tile_rank(keep, sh->warps, &count);
    if (threadIdx.x == 0) publish_count(P.scratch, tile, (unsigned)count);
    if (keep) {
      int64_t *o = s_stage + buf * kCols * T + rank;
      o[kPid * T] = r.pid;
      o[kQsp * T] = r.q_sp;
      o[kDbsp * T] = r.db_sp;
      o[kLength * T] = r.length;
      o[kSid * T] = r.sid;
      o[kStart * T] = r.start;
      o[kOQb * T] = r.qb;
      o[kOQab * T] = r.qab;
      o[kODbb * T] = r.dbb;
      o[kAoff * T] = r.aoff;
      o[kCoff * T] = r.coff;
      o[(kCols - 2) * T] = __double_as_longlong(r.acc_e);
      o[(kCols - 1) * T] = __double_as_longlong(r.hyb_e);
    }
    if (held >= 0)
      expand_write(P, held, tiles, held_count,
                   s_stage + (buf ^ 1) * kCols * T, sh);
    held = tile;
    held_count = count;
    buf ^= 1;
  }
  if (held >= 0)
    expand_write(P, held, tiles, held_count, s_stage + (buf ^ 1) * kCols * T,
                 sh);
}

// shared memory: the warps' counts, the tile and prefix slots, then two
// buffers of staged records, each the kept hits of a tile in rank order:
// pid [T], ints [6][T], floats [3][T]
struct ThreshShared {
  int warps[32];
  int tile;
  unsigned prefix;
};
constexpr int kRecordBytes = 8 + 6 * 4 + 3 * 4;

// A held tile's staged records (`count`, in rank order) to the output rows
// at its prefix, each field a contiguous run (every thread calls it).
__device__ void thresh_write(const ThreshParams &P, int tile, int tiles,
                             int count, const unsigned char *stage,
                             ThreshShared *sh) {
  const int T = blockDim.x;
  const int64_t excl = tile_prefix(P.scratch, tile, tiles, count,
                                   &sh->prefix);
  const int64_t n = P.n;
  const int64_t *s_pid = reinterpret_cast<const int64_t *>(stage);
  const int32_t *s_int = reinterpret_cast<const int32_t *>(s_pid + T);
  const float *s_flt = reinterpret_cast<const float *>(s_int + 6 * T);
  int64_t *o_pid = reinterpret_cast<int64_t *>(P.out);
  int32_t *o_int = reinterpret_cast<int32_t *>(P.out + 8 * n);
  float *o_flt = reinterpret_cast<float *>(P.out + 32 * n);
  for (int k = threadIdx.x; k < count; k += T) {
    o_pid[excl + k] = s_pid[k];
    for (int c = 0; c < 6; ++c) o_int[c * n + excl + k] = s_int[c * T + k];
    for (int c = 0; c < 3; ++c) o_flt[c * n + excl + k] = s_flt[c * T + k];
  }
}

// The expansion's tile order, staging and deferred writes, for the
// threshold's records.
__global__ void thresh_kernel(ThreshParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  ThreshShared *sh = reinterpret_cast<ThreshShared *>(smem);
  const int T = blockDim.x;
  unsigned char *s_stage = smem + sizeof(ThreshShared);  // [2][44 T]
  const int tiles = (P.n + T - 1) / T;
  int held = -1, held_count = 0, buf = 0;
  for (int tile = next_tile(P.scratch, &sh->tile); tile < tiles;
       tile = next_tile(P.scratch, &sh->tile)) {
    const int t = tile * T + threadIdx.x;
    const float energy = t < P.n ? P.energy[t] : 0.0f;
    const bool keep = t < P.n && (double)energy <= P.threshold;
    int count;
    const int rank = tile_rank(keep, sh->warps, &count);
    if (threadIdx.x == 0) publish_count(P.scratch, tile, (unsigned)count);
    if (keep) {
      unsigned char *stage = s_stage + buf * kRecordBytes * T;
      int64_t *s_pid = reinterpret_cast<int64_t *>(stage);
      int32_t *s_int = reinterpret_cast<int32_t *>(s_pid + T);
      float *s_flt = reinterpret_cast<float *>(s_int + 6 * T);
      s_pid[rank] = P.pid[t];
      // int64 -> int32 as numpy's astype: the low 32 bits
      s_int[rank] = (int32_t)P.q_sp[t];
      s_int[T + rank] = (int32_t)P.db_sp[t];
      s_int[2 * T + rank] = (int32_t)P.q_len[t];
      s_int[3 * T + rank] = (int32_t)P.db_len[t];
      s_int[4 * T + rank] = (int32_t)P.start[t];
      s_int[5 * T + rank] = (int32_t)P.sid[t];
      s_flt[rank] = P.acc_e[t];
      s_flt[T + rank] = P.hyb_e[t];
      s_flt[2 * T + rank] = energy;
    }
    if (held >= 0)
      thresh_write(P, held, tiles, held_count,
                   s_stage + (buf ^ 1) * kRecordBytes * T, sh);
    held = tile;
    held_count = count;
    buf ^= 1;
  }
  if (held >= 0)
    thresh_write(P, held, tiles, held_count,
                 s_stage + (buf ^ 1) * kRecordBytes * T, sh);
}

// one launch of `kern` over `tiles` tiles on `grid` CTAs (0: as many as
// the card holds at once), at most one per tile; the only launch site of
// this file
template <typename P>
int run(void (*kern)(P), long long tiles, long long grid, int threads,
        size_t bytes, void *stream, const P &p) {
  int dev = 0, max_smem = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (bytes > (size_t)max_smem) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  if (grid == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      bytes);
    if (e != cudaSuccess) return (int)e;
    grid = (long long)sms * (per_sm > 1 ? per_sm : 1);
  }
  if (grid > tiles) grid = tiles;
  if (grid < 1 || grid > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  kern<<<(int)grid, threads, bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

bool bad_threads(long long threads) {
  return threads < 32 || threads > 1024 || threads % 32 != 0;
}

// zero the launch's scratch (the counter, the total, the tile states) on
// the stream, ahead of the launch
int clear(unsigned long long *scratch, long long tiles, void *stream) {
  return (int)cudaMemsetAsync(scratch, 0, (kStates + tiles) * sizeof(*scratch),
                              (cudaStream_t)stream);
}

}  // namespace

// ptrs: cum, cand, energy, q_sa, db_sa, pos_sid, pos_ls, pos_aoff,
//   pos_coff, q_acc, q_cond, db_acc, db_cond, scratch (int64, 2 + tiles,
//   zeroed here; the survivors' count is left in [1]), ints [11][B], floats
//   [2][B] (16 device pointers);
// sizes: nc, n_qsa, n_dsa, n_pos, n_qacc, n_qcond, n_dacc, n_dcond, o, B,
//   d, max_len, threads per CTA (a multiple of 32), CTAs (0: as many as
//   the card holds at once);
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
  p.scratch = (unsigned long long *)ptrs[13];
  p.ints = (int64_t *)ptrs[14];
  p.floats = (double *)ptrs[15];
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
  const long long threads = sizes[12], grid = sizes[13];
  if (B == 0) return 0;
  if (B < 0 || B > kMaxBlock || p.o < 0) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 8; ++k)  // the wrapper checks the same
    if (sizes[k] < 1) return (int)cudaErrorInvalidValue;
  if (bad_threads(threads) || grid < 0) return (int)cudaErrorInvalidConfiguration;
  p.B = (int)B;
  const long long tiles = (B + threads - 1) / threads;
  const size_t bytes = sizeof(ExpandShared) +
                       (threads + 1 + 2 * kCols * threads) * sizeof(int64_t);
  const int err = clear(p.scratch, tiles, stream);
  return err != 0 ? err : run(expand_kernel, tiles, grid, (int)threads,
                              bytes, stream, p);
}

// ptrs: q_sp, db_sp, q_len, db_len, dbseq_start (int64), acc_e, hyb_e,
//   energy (float32) of the ungapped output, dbseq_id, pid (int64) of its
//   hits, scratch (int64, 2 + tiles, zeroed here; the kept hits' count is
//   left in [1]), out (44 bytes per hit) (12 device pointers);
// sizes: n, threads per CTA (a multiple of 32), CTAs (0: as many as the
//   card holds at once);
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
  p.scratch = (unsigned long long *)ptrs[10];
  p.out = (unsigned char *)ptrs[11];
  const long long n = sizes[0], threads = sizes[1], grid = sizes[2];
  p.threshold = scalars[0];
  if (n == 0) return 0;
  if (n < 0 || n > kMaxBlock) return (int)cudaErrorInvalidValue;
  if (bad_threads(threads) || grid < 0) return (int)cudaErrorInvalidConfiguration;
  p.n = (int)n;
  const long long tiles = (n + threads - 1) / threads;
  const size_t bytes = sizeof(ThreshShared) + 2 * kRecordBytes * threads;
  const int err = clear(p.scratch, tiles, stream);
  return err != 0 ? err : run(thresh_kernel, tiles, grid, (int)threads,
                              bytes, stream, p);
}

// ptrs: out (the records, laid out for a capacity of n), host (a buffer
//   laid out for c records);
// sizes: r0, m, n, c: records r0 .. r0 + m - 1 into host rows 0 .. m - 1;
// scalars: unused.
// Copies pid, the six int32 rows and the three float32 rows, each cut to
// the m records: three copies on `stream` (asynchronous where the host
// buffer is pinned).
extern "C" int fused_records_to_host(void *const *ptrs,
                                     const long long *sizes, const double *,
                                     void *stream) {
  const unsigned char *out = (const unsigned char *)ptrs[0];
  unsigned char *host = (unsigned char *)ptrs[1];
  const long long r0 = sizes[0], m = sizes[1], n = sizes[2], c = sizes[3];
  if (r0 < 0 || m < 0 || r0 + m > n || m > c) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  int err = (int)cudaMemcpyAsync(host, out + 8 * r0, 8 * m,
                                 cudaMemcpyDeviceToHost, s);
  if (err == 0)
    err = (int)cudaMemcpy2DAsync(host + 8 * c, 4 * c, out + 8 * n + 4 * r0,
                                 4 * n, 4 * m, 6, cudaMemcpyDeviceToHost, s);
  if (err == 0)
    err = (int)cudaMemcpy2DAsync(host + 32 * c, 4 * c, out + 32 * n + 4 * r0,
                                 4 * n, 4 * m, 3, cudaMemcpyDeviceToHost, s);
  return err;
}

// ptrs: a host pointer to a cudaStream_t, set to a new stream of the
//   current device that does not wait on the legacy default stream (the
//   records' copies);
// sizes, scalars: unused.
extern "C" int fused_copy_stream(void *const *ptrs, const long long *,
                                 const double *, void *) {
  return (int)cudaStreamCreateWithFlags((cudaStream_t *)ptrs[0],
                                        cudaStreamNonBlocking);
}
