// Row staging for the per-pixel passes: 16-byte asynchronous copies
// (cp.async) of the chunks that cover a byte range of device memory into
// shared memory and 16-byte stores of a staged range back (csrc/warp.cu),
// an L2 prefetch (csrc/blur_select.cu), and the once-per-process launch
// set-up of both kernels: their shared memory limit, and the grid that
// fills the card at once.
//
// load_chunks reads whole 16-byte-aligned chunks, so it may read up to 15
// bytes before and after the range. Each chunk holds at least one byte of
// the range, so it lies in the same page and the same allocation (PyTorch's
// caching allocator hands out 512-byte-aligned blocks); the extra bytes are
// never used. That keeps rows of any width and alignment (61 x 97 frames,
// strips that start mid-pixel) on one path with no byte loads.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace vrvg {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's most recent groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bring the cache line holding `p` into L2 ahead of its use.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Bytes of a shared-memory slot that load_chunks fills for an n-byte range
// (or that store_bytes reads, staged at the destination's alignment).
__host__ __device__ constexpr int chunk_bytes(int n) {
  return (n + 30) & ~15;
}

// Where the first byte of `p` lands in a slot: its offset in its chunk.
__device__ __forceinline__ int chunk_head(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// Issue, spread over the block's threads, the copies of the 16-byte chunks
// covering device bytes [src, src + n) into `dst` (16-byte aligned, at least
// chunk_bytes(n) long). src's first byte lands at dst + chunk_head(src).
// The caller commits the group and waits for it.
__device__ __forceinline__ void load_chunks(uint8_t* dst, const void* src,
                                            int n, int tid, int nthreads) {
  const uintptr_t first = reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15);
  const int chunks = (chunk_head(src) + n + 15) >> 4;
  for (int k = tid; k < chunks; k += nthreads)
    cp_async16(dst + 16 * k, reinterpret_cast<const void*>(first + 16 * k));
}

// Store n bytes staged at `src` (shared, staged at dst's alignment: at a
// slot's base + chunk_head(dst)) to `dst` (device), spread over the
// block's threads: the 16-byte chunks inside the range one store each, the
// partial chunks at either end byte by byte.
__device__ __forceinline__ void store_bytes(uint8_t* dst, const uint8_t* src,
                                            int n, int tid, int nthreads) {
  const int head = min(n, (16 - chunk_head(dst)) & 15);
  const int body = (n - head) >> 4;
  const uint4* s = reinterpret_cast<const uint4*>(src + head);
  uint4* d = reinterpret_cast<uint4*>(dst + head);
  for (int k = tid; k < body; k += nthreads) d[k] = s[k];
  const int tail = head + 16 * body;
  for (int i = tid; i < head + n - tail; i += nthreads) {
    const int j = i < head ? i : tail + i - head;
    dst[j] = src[j];
  }
}

// What a launch of a kernel needs to know of the device: its SM count and
// how many blocks of the kernel fit on one SM at once.
struct LaunchLimits {
  int sms, blocks_per_sm;
};

// Once per (kernel, device, block size, shared memory) and process: allow
// `kernel` the device's whole opt-in shared memory (cudaFuncSetAttribute)
// and ask the occupancy calculator how many such blocks an SM holds, so a
// launch makes neither call. cudaErrorInvalidValue if `smem` is more than
// a block may take.
inline cudaError_t launch_limits(const void* kernel, int threads, size_t smem,
                                 LaunchLimits* out) {
  struct Entry {
    const void* kernel;
    int device, threads;
    size_t smem;
    LaunchLimits limits;
  };
  static std::mutex mu;
  static Entry seen[64];
  static int n_seen = 0;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i) {
    const Entry& e = seen[i];
    if (e.kernel == kernel && e.device == device && e.threads == threads &&
        e.smem == smem) {
      *out = e.limits;
      return cudaSuccess;
    }
  }
  LaunchLimits lim;
  int optin;
  if ((err = cudaDeviceGetAttribute(&lim.sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&optin,
                                    cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    device)) != cudaSuccess)
    return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &lim.blocks_per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (lim.blocks_per_sm < 1) return cudaErrorInvalidValue;
  if (n_seen < 64) seen[n_seen++] = Entry{kernel, device, threads, smem, lim};
  *out = lim;
  return cudaSuccess;
}

}  // namespace vrvg
