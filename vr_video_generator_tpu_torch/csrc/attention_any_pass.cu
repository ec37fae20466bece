// The passes before kernel 1's wgmma kernels (csrc/attention_any.cu,
// csrc/attention_any_f32.cu), part of each of their launches and counted
// with it: neither replaces a TPU kernel; they lay q, k and v out where TMA
// can read them.
//
// pad_kernel (bf16): where TMA cannot read the views (a head dim that is no
// multiple of 8, or a token or batch stride or an address that is no
// multiple of 16 bytes: an odd head dim's qkv views), q, k and v are
// written contiguous with rows of round_up(Dh, 8), zeros past Dh, into the
// wrapper's scratch, [q | k | v] each (B, N, H, round_up(Dh, 8)).
//
// split_kernel (f32): q, k and v (any strides, no alignment) to their TF32
// hi/lo planes (csrc/tf32x3.cuh split), zero-padded to DP columns and Npad
// rows: Q_hi, Q_lo, K_hi, K_lo each (B H Npad, DP), then V^T_hi, V^T_lo
// each (B H DP, Npad), each 8-key group of V^T in tf32x3::pv_slot_key's
// order (so that the S accumulator's registers are P V's A fragment as
// they lie). A block takes 32 keys of one (head, batch); V^T goes through
// shared memory in 32 x 32 tiles.
//
// What bounds them: bytes (read q, k, v once; write 3 (bf16) or 6 (f32)
// padded planes): ~20-60 us at the phase-12 shapes, against 0.2-2 ms of the
// kernel. No wgmma, TMA or shuffle: g++ builds this file against
// tests/cuda_emu (tests/test_torch_attention_any_pass.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int PAD_THREADS = 256;
constexpr int SPLIT_THREADS = 256;
constexpr int SPLIT_KEYS = 32;

__global__ void __launch_bounds__(PAD_THREADS)
    pad_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, uint16_t* __restrict__ out,
               int n, int heads, int d, int dp, long long q_sb,
               long long q_sn, long long k_sb, long long k_sn, long long v_sb,
               long long v_sn) {
  const int which = blockIdx.y, b = blockIdx.z;
  const uint16_t* src = which == 0 ? q : which == 1 ? k : v;
  const long long sb = which == 0 ? q_sb : which == 1 ? k_sb : v_sb;
  const long long sn = which == 0 ? q_sn : which == 1 ? k_sn : v_sn;
  const long long per_batch = (long long)n * heads * dp;
  uint16_t* dst = out + (which * (long long)gridDim.z + b) * per_batch;
  for (long long e = (long long)blockIdx.x * PAD_THREADS + threadIdx.x;
       e < per_batch; e += (long long)gridDim.x * PAD_THREADS) {
    const int c = (int)(e % dp);
    const long long rest = e / dp;
    const int h = (int)(rest % heads);
    const long long row = rest / heads;
    dst[e] = c < d ? src[b * sb + row * sn + (long long)h * d + c] : 0;
  }
}

__device__ __forceinline__ void split_store(float x, float* hi, float* lo) {
  uint32_t h, l;
  tf32x3::split(x, h, l);
  *hi = tf32x3::from_bits(h);
  *lo = tf32x3::from_bits(l);
}

__global__ void __launch_bounds__(SPLIT_THREADS)
    split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ ws, int n,
                 int npad, int heads, int d, int dp, long long q_sb,
                 long long q_sn, long long k_sb, long long k_sn,
                 long long v_sb, long long v_sn) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* vs = reinterpret_cast<float*>(smem);  // 32 keys x 33
  const int key0 = blockIdx.x * SPLIT_KEYS, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * heads + h;
  const long long plane = (long long)gridDim.z * heads * npad * dp;
  // Q and K: rows key0 .. key0 + 31 of this (batch, head), DP columns.
  for (int e = threadIdx.x; e < SPLIT_KEYS * dp; e += SPLIT_THREADS) {
    const int r = e / dp, c = e % dp;
    const int row = key0 + r;
    const bool in = row < n && c < d;
    const long long at = (bh * npad + row) * dp + c;
    const long long src = (long long)h * d + c;
    split_store(in ? q[b * q_sb + row * q_sn + src] : 0.f, ws + at,
                ws + plane + at);
    split_store(in ? k[b * k_sb + row * k_sn + src] : 0.f,
                ws + 2 * plane + at, ws + 3 * plane + at);
  }
  // V^T: for each 32-dim chunk, the 32 x 32 tile through shared memory.
  float* vt = ws + 4 * plane;
  for (int c0 = 0; c0 < dp; c0 += 32) {
    __syncthreads();
    for (int e = threadIdx.x; e < SPLIT_KEYS * 32; e += SPLIT_THREADS) {
      const int r = e / 32, c = e % 32;
      const int row = key0 + r;
      vs[r * 33 + c] = row < n && c0 + c < d
                           ? v[b * v_sb + row * v_sn + (long long)h * d + c0 +
                               c]
                           : 0.f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < 32 * SPLIT_KEYS; e += SPLIT_THREADS) {
      const int c = e / SPLIT_KEYS, slot = e % SPLIT_KEYS;
      const int key = (slot & ~7) + tf32x3::pv_slot_key(slot & 7);
      const long long at = (bh * dp + c0 + c) * npad + key0 + slot;
      split_store(vs[key * 33 + c], vt + at, vt + plane + at);
    }
  }
}

}  // namespace

// (B, N, H, d) bf16 views q, k, v (element strides) -> out: [q | k | v],
// each (B, N, H, dp) contiguous, zeros in columns [d, dp).
extern "C" int vrvg_attention_any_pad(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int n, int heads, int d, int dp,
                                      long long q_sb, long long q_sn,
                                      long long k_sb, long long k_sn,
                                      long long v_sb, long long v_sn,
                                      void* stream) {
  const long long per_batch = (long long)n * heads * dp;
  const long long blocks = (per_batch + PAD_THREADS - 1) / PAD_THREADS;
  const dim3 grid((unsigned)(blocks < 1024 ? blocks : 1024), 3, batch);
  pad_kernel<<<grid, PAD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)q, (const uint16_t*)k, (const uint16_t*)v,
      (uint16_t*)out, n, heads, d, dp, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn);
  return (int)cudaGetLastError();
}

// (B, N, H, d) f32 views q, k, v -> ws: Q_hi, Q_lo, K_hi, K_lo (B H npad,
// dp), V^T_hi, V^T_lo (B H dp, npad); npad a multiple of 32, dp of 32.
extern "C" int vrvg_attention_any_split(const void* q, const void* k,
                                        const void* v, void* ws, int batch,
                                        int n, int npad, int heads, int d,
                                        int dp, long long q_sb,
                                        long long q_sn, long long k_sb,
                                        long long k_sn, long long v_sb,
                                        long long v_sn, void* stream) {
  const dim3 grid(npad / SPLIT_KEYS, heads, batch);
  split_kernel<<<grid, SPLIT_THREADS, SPLIT_KEYS * 33 * sizeof(float),
                 (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)ws, n, npad,
      heads, d, dp, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn);
  return (int)cudaGetLastError();
}
