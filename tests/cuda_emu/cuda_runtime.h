// A CPU stand-in for the CUDA runtime and device built-ins that
// priblast_tpu_torch/csrc/gapped_extend.cu uses, so that g++ can compile
// that source and run it: tests/test_torch_kernel_emu.py holds the result
// against the kernel's plain PyTorch version on a machine without a card.
//
// One warp per block: every lane is a std::thread, and __syncwarp,
// __syncthreads, the ballots, the reductions and the shuffles meet at one
// barrier. The test
// rewrites the kernel launch `k<<<grid, threads, smem, stream>>>(p)` into
// emu_launch(k, grid, threads, smem, p), which runs the blocks one after
// another, and defines the dynamic shared memory array in the kernel's
// namespace.
#pragma once
#include <algorithm>
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
enum { cudaSuccess = 0, cudaErrorInvalidConfiguration = 9 };
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

struct EmuBarrier {
  std::mutex m;
  std::condition_variable cv;
  int n = 0, count = 0, gen = 0;
  void wait() {
    std::unique_lock<std::mutex> lk(m);
    const int g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(lk, [&] { return gen != g; });
    }
  }
};
inline EmuBarrier emu_bar;
inline int64_t emu_slot[32];

inline void __syncthreads() { emu_bar.wait(); }
inline void __syncwarp() { emu_bar.wait(); }
inline unsigned __ballot_sync(unsigned, bool pred) {
  emu_bar.wait();
  emu_slot[threadIdx.x] = pred;
  emu_bar.wait();
  unsigned m = 0;
  for (int k = 0; k < 32; ++k)
    if (emu_slot[k]) m |= 1u << k;
  emu_bar.wait();
  return m;
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  emu_bar.wait();
  emu_slot[threadIdx.x] = v;
  emu_bar.wait();
  unsigned m = 0;
  for (int k = 0; k < (int)blockDim.x; ++k) m |= (unsigned)emu_slot[k];
  emu_bar.wait();
  return m;
}
inline bool __any_sync(unsigned mask, bool pred) {
  return __ballot_sync(mask, pred) != 0;
}
template <class T> T __shfl_xor_sync(unsigned, T v, int off) {
  emu_bar.wait();
  int64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  emu_slot[threadIdx.x] = bits;
  emu_bar.wait();
  const int64_t o = emu_slot[threadIdx.x ^ off];
  T r;
  std::memcpy(&r, &o, sizeof(T));
  emu_bar.wait();
  return r;
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline float __int_as_float(int x) {
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}
inline double __longlong_as_double(long long x) {
  double f;
  std::memcpy(&f, &x, 8);
  return f;
}

template <class P>
void emu_launch(void (*kernel)(P), int grid, int threads, size_t,
                const P &p) {
  gridDim.x = grid;
  blockDim.x = threads;
  emu_bar.n = threads;
  for (int b = 0; b < grid; ++b) {
    std::vector<std::thread> lanes;
    for (int t = 0; t < threads; ++t)
      lanes.emplace_back([&, b, t] {
        blockIdx.x = b;
        threadIdx.x = t;
        kernel(p);
      });
    for (auto &th : lanes) th.join();
  }
}
