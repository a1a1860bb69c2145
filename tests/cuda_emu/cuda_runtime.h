// A CPU stand-in for the CUDA runtime and device built-ins that the
// kernels in priblast_tpu_torch/csrc/ use, so that g++ can compile those
// sources and run them: tests/test_torch_kernel_emu.py holds the results
// against the kernels' plain PyTorch versions on a machine without a card.
//
// Every thread of a block is a std::thread. __syncthreads meets at the
// block's barrier; __syncwarp, the ballots, the reductions and the
// shuffles meet at the barrier of the calling thread's warp (32 threads,
// fewer in a block's last warp), so one warp can run them while the
// others wait at __syncthreads. The test
// rewrites the kernel launch `k<<<grid, threads, smem, stream>>>(p)` into
// emu_launch(k, grid, threads, smem, p), which runs the blocks one after
// another, or, after emu_concurrent_blocks(1), all of them at once (a
// block's threads may then wait on another block's, as a decoupled
// look-back does), and the dynamic shared memory declaration into a
// pointer to the block's own (emu_smem). Device memory is host memory:
// atomicAdd is an atomic add, __threadfence a sequentially consistent
// fence, a volatile 64-bit access one access, and the copies memcpy.
#pragma once
#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
using std::max;
using std::min;

struct EmuDim { unsigned x = 0, y = 0, z = 0; };
inline thread_local EmuDim threadIdx, blockIdx;
inline EmuDim blockDim, gridDim;
struct int4 { int x, y, z, w; };
typedef void *cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9 };
enum { cudaDevAttrMultiProcessorCount = 16,
       cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
constexpr int kEmuSms = 3, kEmuSmem = 232448;  // H100's opt-in maximum

inline int cudaGetDevice(int *d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int *v, int attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? kEmuSms : kEmuSmem;
  return 0;
}
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
template <class F>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int *n, F, int threads,
                                                  size_t) {
  *n = threads == 32 ? 1 : 0;  // one warp per block only
  return 0;
}
inline int cudaGetLastError() { return 0; }

// a barrier of n threads: the last to arrive starts the next generation;
// the others spin on it for a while (a warp's threads meet often and soon),
// then sleep
struct EmuBarrier {
  static constexpr int kSpin = 256;
  std::mutex m;
  std::condition_variable cv;
  std::atomic<int> count{0}, gen{0};
  int n = 0;
  void wait() {
    const int g = gen.load(std::memory_order_acquire);
    if (count.fetch_add(1, std::memory_order_acq_rel) + 1 == n) {
      count.store(0, std::memory_order_relaxed);
      {
        std::lock_guard<std::mutex> lk(m);
        gen.fetch_add(1, std::memory_order_acq_rel);
      }
      cv.notify_all();
      return;
    }
    for (int k = 0; k < kSpin; ++k) {
      if (gen.load(std::memory_order_acquire) != g) return;
      std::this_thread::yield();
    }
    std::unique_lock<std::mutex> lk(m);
    cv.wait(lk, [&] { return gen.load(std::memory_order_acquire) != g; });
  }
};
constexpr int kEmuMaxThreads = 1024;
// a block's barriers, exchange slots and shared memory
struct EmuBlock {
  EmuBarrier bar;                          // the block's
  EmuBarrier warp_bar[kEmuMaxThreads / 32];  // one per warp
  // a warp collective's exchange slots, used in turns: a lane can reuse a
  // buffer only after the whole warp has met again, so one wait suffices
  int64_t slot[2][kEmuMaxThreads];
  alignas(16) unsigned char smem[kEmuSmem];
};
inline thread_local EmuBlock *emu_blk = nullptr;  // the calling thread's
inline thread_local int emu_turn = 0;
inline bool emu_concurrent = false;

extern "C" __attribute__((visibility("default"))) void
emu_concurrent_blocks(int on) {
  emu_concurrent = on != 0;
}

inline unsigned char *emu_smem() { return emu_blk->smem; }
inline EmuBarrier &emu_warp() { return emu_blk->warp_bar[threadIdx.x / 32]; }
// first thread and thread count of the calling thread's warp
inline int emu_lane0() { return (int)(threadIdx.x & ~31u); }
inline int emu_lanes() {
  return std::min(32, (int)blockDim.x - emu_lane0());
}
// every lane of the calling warp posts v; returns the posted values
inline const int64_t *emu_exchange(int64_t v) {
  int64_t *slot = emu_blk->slot[emu_turn];
  emu_turn ^= 1;
  slot[threadIdx.x] = v;
  emu_warp().wait();
  return slot;
}

inline void __syncthreads() { emu_blk->bar.wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp().wait(); }
inline unsigned __ballot_sync(unsigned, bool pred) {
  const int64_t *slot = emu_exchange(pred);
  unsigned m = 0;
  for (int k = 0; k < emu_lanes(); ++k)
    if (slot[emu_lane0() + k]) m |= 1u << k;
  return m;
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  const int64_t *slot = emu_exchange(v);
  unsigned m = 0;
  for (int k = 0; k < emu_lanes(); ++k)
    m |= (unsigned)slot[emu_lane0() + k];
  return m;
}
inline bool __any_sync(unsigned mask, bool pred) {
  return __ballot_sync(mask, pred) != 0;
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  const int64_t *slot = emu_exchange(v);
  unsigned s = 0;
  for (int k = 0; k < emu_lanes(); ++k) s += (unsigned)slot[emu_lane0() + k];
  return s;
}
// lane `src` (of the calling warp) of every lane's v; a lane outside the
// warp reads its own, as __shfl_up_sync / __shfl_down_sync do
template <class T> T emu_shfl(T v, int src) {
  int64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  const int64_t *slot = emu_exchange(bits);
  const int64_t o = src >= 0 && src < emu_lanes() ? slot[emu_lane0() + src]
                                                   : bits;
  T r;
  std::memcpy(&r, &o, sizeof(T));
  return r;
}
inline int emu_lane() { return (int)threadIdx.x - emu_lane0(); }
template <class T> T __shfl_xor_sync(unsigned, T v, int off) {
  return emu_shfl(v, emu_lane() ^ off);
}
template <class T> T __shfl_up_sync(unsigned, T v, int off) {
  return emu_shfl(v, emu_lane() >= off ? emu_lane() - off : emu_lane());
}
template <class T> T __shfl_down_sync(unsigned, T v, int off) {
  return emu_shfl(v, emu_lane() + off);
}
template <class T> T __shfl_sync(unsigned, T v, int src) {
  return emu_shfl(v, src & 31);
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <class T> T __ldg(const T *p) { return *p; }
inline float __int_as_float(int x) {
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}
inline long long __double_as_longlong(double x) {
  long long f;
  std::memcpy(&f, &x, 8);
  return f;
}
inline double __longlong_as_double(long long x) {
  double f;
  std::memcpy(&f, &x, 8);
  return f;
}

template <class T> T atomicAdd(T *p, T v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline long long clock64() {
  return std::chrono::steady_clock::now().time_since_epoch().count();
}
inline void __nanosleep(unsigned) { std::this_thread::yield(); }

enum cudaMemcpyKind { cudaMemcpyDeviceToHost = 2 };
enum { cudaStreamNonBlocking = 1 };
inline int cudaStreamCreateWithFlags(cudaStream_t *s, unsigned) {
  *s = nullptr;
  return 0;
}
template <class S> int cudaMemcpyFromSymbol(void *dst, const S &sym,
                                            size_t n) {
  std::memcpy(dst, &sym, n);
  return 0;
}
template <class S> int cudaMemcpyToSymbol(S &sym, const void *src, size_t n) {
  std::memcpy(&sym, src, n);
  return 0;
}
inline int cudaMemsetAsync(void *p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
inline int cudaMemcpyAsync(void *dst, const void *src, size_t n,
                           cudaMemcpyKind, cudaStream_t) {
  std::memcpy(dst, src, n);
  return 0;
}
inline int cudaMemcpy2DAsync(void *dst, size_t dpitch, const void *src,
                             size_t spitch, size_t width, size_t height,
                             cudaMemcpyKind, cudaStream_t) {
  for (size_t r = 0; r < height; ++r)
    std::memcpy((char *)dst + r * dpitch, (const char *)src + r * spitch,
                width);
  return 0;
}

template <class P>
void emu_launch(void (*kernel)(P), int grid, int threads, size_t,
                const P &p) {
  if (threads < 1 || threads > kEmuMaxThreads) return;
  gridDim.x = grid;
  blockDim.x = threads;
  // the blocks at once, or one block's storage used in turn
  std::vector<EmuBlock> blocks(emu_concurrent ? grid : 1);
  for (EmuBlock &blk : blocks) {
    blk.bar.n = threads;
    for (int w = 0; w * 32 < threads; ++w)
      blk.warp_bar[w].n = std::min(32, threads - 32 * w);
  }
  std::vector<std::thread> lanes;
  auto start = [&](int b) {
    for (int t = 0; t < threads; ++t)
      lanes.emplace_back([&, b, t] {
        emu_blk = &blocks[emu_concurrent ? b : 0];
        blockIdx.x = b;
        threadIdx.x = t;
        kernel(p);
      });
  };
  for (int b = 0; b < grid; ++b) {
    start(b);
    if (!emu_concurrent) {
      for (auto &th : lanes) th.join();
      lanes.clear();
    }
  }
  for (auto &th : lanes) th.join();
}
