// A host emulation of the CUDA runtime and device built-ins that the
// port's per-pixel kernels (csrc/warp.cu, csrc/blur_select.cu) use, so g++
// can compile those sources unchanged and run them on the CPU: every CUDA
// thread of a block is a std::thread, __syncthreads is a std::barrier,
// blocks run one after another, and "device" pointers are host pointers
// (CPU tensors); __syncwarp is a barrier of the thread's 32.
// tests/test_torch_kernel_emulation.py builds and drives it.
// It checks the kernels' logic (indexing, rings, alignment, the order of
// their barriers and asynchronous copies), not their speed.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdlib>
#include <deque>
#include <memory>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return uint4{x, y, z, w};
}
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

namespace emu {
inline thread_local std::barrier<>* block_barrier = nullptr;
inline thread_local std::barrier<>* warp_barrier = nullptr;
}  // namespace emu

inline void __syncthreads() { emu::block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu::warp_barrier->arrive_and_wait();
}

inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __uint_as_float(uint32_t v) {
  float f;
  memcpy(&f, &v, 4);
  return f;
}
inline int __ffs(int v) { return __builtin_ffs(v); }
template <typename T>
inline T __ldg(const T* p) {
  return *p;
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t shift) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (shift & 31));
}

inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> a(*p);
  int old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}

// Runtime API.
typedef enum cudaError {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
} cudaError_t;
typedef struct CUstream_st* cudaStream_t;
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount,
  cudaDevAttrMaxSharedMemoryPerBlockOptin,
  cudaDevAttrMaxSharedMemoryPerMultiprocessor,
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };

inline size_t& emu_shared_bytes() {
  static size_t bytes = 0;
  return bytes;
}

// The emulated device's number is its SM count: EMU_SMS, 2 by default.
// The SM count sets how many blocks the kernels' host code launches, and
// as a device number it keeps each setting's launch limits apart in the
// kernels' once-per-device cache.
inline cudaError_t cudaGetDevice(int* d) {
  const char* sms = getenv("EMU_SMS");
  *d = sms ? atoi(sms) : 2;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int d) {
  switch (a) {
    case cudaDevAttrMultiProcessorCount:
      *v = d;
      break;
    case cudaDevAttrMaxSharedMemoryPerBlockOptin:
      *v = 232448;
      break;
    case cudaDevAttrMaxSharedMemoryPerMultiprocessor:
      *v = 233472;
      break;
  }
  return cudaSuccess;
}
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute,
                                        int bytes) {
  emu_shared_bytes() = (size_t)bytes;
  return cudaSuccess;
}
template <typename T>
cudaError_t cudaFuncSetAttribute(T* kernel, cudaFuncAttribute a, int bytes) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel), a, bytes);
}
// What the card's occupancy calculator would say for blocks limited by
// threads and shared memory alone.
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, const void*, int threads, size_t smem) {
  const int by_threads = 2048 / threads;
  const int by_smem = (int)(233472 / (smem + 1024));
  *n = by_threads < by_smem ? by_threads : by_smem;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

namespace emu {

// The block's dynamic shared memory (one block runs at a time): the array
// `smem` each including file defines in its unnamed namespace, where the
// kernels' `extern __shared__` declarations find it. It is filled with a
// poison byte before each block.
constexpr size_t SHARED_BYTES = 1 << 18;
static unsigned char* shared_memory();

// kernel<<<grid, block, smem, stream>>>(args...) is rewritten to
// emu::Launch(grid, block, smem, stream)(kernel, args...).
struct Launch {
  dim3 grid, block;
  size_t smem;
  Launch(dim3 g, dim3 b, size_t s = 0, cudaStream_t = nullptr)
      : grid(g), block(b), smem(s) {}
  template <typename F, typename... A>
  void operator()(F kernel, A... args) const {
    if (smem > SHARED_BYTES || (smem > 48 * 1024 && smem > emu_shared_bytes()))
      abort();
    const int threads = block.x * block.y * block.z;
    for (unsigned bz = 0; bz < grid.z; ++bz)
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          memset(shared_memory(), 0xAB, SHARED_BYTES);
          std::barrier<> bar(threads);
          std::vector<std::unique_ptr<std::barrier<>>> warps;
          for (int t = 0; t < threads; t += 32)
            warps.emplace_back(new std::barrier<>(std::min(32, threads - t)));
          std::vector<std::thread> pool;
          for (int t = 0; t < threads; ++t)
            pool.emplace_back([&, t] {
              block_barrier = &bar;
              warp_barrier = warps[t / 32].get();
              threadIdx = dim3(t % block.x, t / block.x % block.y,
                               t / (block.x * block.y));
              blockIdx = dim3(bx, by, bz);
              blockDim = block;
              gridDim = grid;
              kernel(args...);
            });
          for (auto& th : pool) th.join();
        }
  }
};

// cp.async: the destination is poisoned at issue and written when a wait
// retires its group, so a read before the wait, or a copy into a slot
// another thread still reads, shows up as poison in the output. The poison
// is 0x00 or 0xCD by the chunk's address, so a flag read too early is seen
// both set and clear.
struct Copy {
  void* dst;
  unsigned char data[16];
};
inline thread_local std::vector<Copy> open_group;
inline thread_local std::deque<std::vector<Copy>> groups;

inline void cp_async16(void* dst, const void* src) {
  Copy c;
  c.dst = dst;
  memcpy(c.data, src, 16);
  memset(dst, (reinterpret_cast<uintptr_t>(dst) >> 4) & 1 ? 0x00 : 0xCD, 16);
  open_group.push_back(c);
}
inline void cp_async_commit() {
  groups.push_back(std::move(open_group));
  open_group.clear();
}
inline void cp_async_wait(size_t n) {
  while (groups.size() > n) {
    for (const Copy& c : groups.front()) memcpy(c.dst, c.data, 16);
    groups.pop_front();
  }
}

}  // namespace emu
