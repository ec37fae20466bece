// Stereo forward-warp compositor, for Hopper (sm_90a).
//
// Replaces: vr_video_generator_tpu/ops/warp_pallas.py `_composite_prepacked`
// (kernel body `_warp_kernel`). For each shift s of the frame's shift table
// (ascending s = far -> near on the TPU), output pixel x takes source pixel
// x - s (circular in x) when the shift is valid and lo[s] <= depth[x - s] <
// hi[s]; the last match wins. Pixels no shift claims take the source pixel
// x - fill_offset and are reported as not covered.
//
// What bounds it on the H100: per 1080p frame it reads 8 MB of depth and
// 6 MB of RGB and writes 6 MB + 2 MB, ~0.17 GB per 8-frame batch, about
// 50 us at 3.35 TB/s; the arithmetic is at most S = 69 compares per pixel.
// The TPU kernel rotated whole row blocks once per shift because Mosaic
// only rotates lanes; a GPU thread can gather instead.
//
// Design: one block per (row, frame) stages the row's depth and RGB in
// shared memory (so the circular reads cost no extra device traffic) with
// the frame's lo/hi/valid tables beside them; one thread per output pixel
// walks the shifts DESCENDING and stops at the first match, which is the
// TPU's last-write-wins result without writing the losers. The frame is
// read as u8 HWC directly: the u32 packing on the TPU was a Mosaic
// constraint, not part of the semantics.
//
// The banded compositor (`warp_composite_banded_kernel`) replaces
// warp_pallas.py `_warp_kernel_banded`, the TPU's one-rotate-per-shift arm
// (`_composite_prepacked(banded=True)`, at most 126 shifts). A first pass
// over the staged row computes one code byte per SOURCE pixel: walking the
// valid shifts ascending with the same f32 lo <= d < hi compares on the
// unshifted depth, the rank (cumsum(valid) - valid, from the wrapper) of
// the first band that matches, | 128 when a second one does, 254 when none
// does. The output pass walks the shifts descending and stops at the first
// whose rank bj the gathered code hits three ways (iv == bj, bj + 127,
// bj + 128), then gathers that pixel's RGB. Same bytes as the classic
// kernel; it trades the per-shift depth read for a byte read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
warp_composite_kernel(const uint8_t* __restrict__ img,
                      const float* __restrict__ depth,
                      const float* __restrict__ lo,
                      const float* __restrict__ hi,
                      const uint8_t* __restrict__ valid,
                      const int* __restrict__ fill, uint8_t* __restrict__ out,
                      uint8_t* __restrict__ covered, int h, int w, int s_neg,
                      int n_shift) {
  const int y = blockIdx.x;
  const int b = blockIdx.y;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_depth = reinterpret_cast<float*>(smem);
  float* s_lo = s_depth + w;
  float* s_hi = s_lo + n_shift;
  int* s_valid = reinterpret_cast<int*>(s_hi + n_shift);
  uint8_t* s_rgb = reinterpret_cast<uint8_t*>(s_valid + n_shift);

  const long long row = (long long)b * h + y;
  const float* drow = depth + row * w;
  const uint8_t* irow = img + row * w * 3;
  for (int i = threadIdx.x; i < w; i += THREADS) s_depth[i] = drow[i];
  for (int i = threadIdx.x; i < 3 * w; i += THREADS) s_rgb[i] = irow[i];
  for (int i = threadIdx.x; i < n_shift; i += THREADS) {
    s_lo[i] = lo[(long long)b * n_shift + i];
    s_hi[i] = hi[(long long)b * n_shift + i];
    s_valid[i] = valid[(long long)b * n_shift + i];
  }
  __syncthreads();

  const int f = fill[b];
  for (int x = threadIdx.x; x < w; x += THREADS) {
    int src = -1;
    for (int j = n_shift - 1; j >= 0; --j) {
      if (!s_valid[j]) continue;
      int sx = (x - (j - s_neg)) % w;
      if (sx < 0) sx += w;
      const float d = s_depth[sx];
      if (s_lo[j] <= d && d < s_hi[j]) {
        src = sx;
        break;
      }
    }
    const bool cov = src >= 0;
    if (!cov) {
      src = (x - f) % w;
      if (src < 0) src += w;
    }
    uint8_t* dst = out + (row * w + x) * 3;
    dst[0] = s_rgb[src * 3 + 0];
    dst[1] = s_rgb[src * 3 + 1];
    dst[2] = s_rgb[src * 3 + 2];
    covered[row * w + x] = cov ? 1 : 0;
  }
}

__global__ void __launch_bounds__(THREADS)
warp_composite_banded_kernel(const uint8_t* __restrict__ img,
                             const float* __restrict__ depth,
                             const float* __restrict__ lo,
                             const float* __restrict__ hi,
                             const uint8_t* __restrict__ valid,
                             const int* __restrict__ bid,
                             const int* __restrict__ fill,
                             uint8_t* __restrict__ out,
                             uint8_t* __restrict__ covered, int h, int w,
                             int s_neg, int n_shift) {
  const int y = blockIdx.x;
  const int b = blockIdx.y;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_lo = reinterpret_cast<float*>(smem);
  float* s_hi = s_lo + n_shift;
  int* s_valid = reinterpret_cast<int*>(s_hi + n_shift);
  int* s_bid = s_valid + n_shift;
  uint8_t* s_code = reinterpret_cast<uint8_t*>(s_bid + n_shift);
  uint8_t* s_rgb = s_code + w;

  const long long row = (long long)b * h + y;
  const float* drow = depth + row * w;
  const uint8_t* irow = img + row * w * 3;
  for (int i = threadIdx.x; i < 3 * w; i += THREADS) s_rgb[i] = irow[i];
  for (int i = threadIdx.x; i < n_shift; i += THREADS) {
    s_lo[i] = lo[(long long)b * n_shift + i];
    s_hi[i] = hi[(long long)b * n_shift + i];
    s_valid[i] = valid[(long long)b * n_shift + i];
    s_bid[i] = bid[(long long)b * n_shift + i];
  }
  __syncthreads();

  // The code byte of each source pixel, from its own (unshifted) depth.
  for (int x = threadIdx.x; x < w; x += THREADS) {
    const float d = drow[x];
    int code = 254;
    for (int j = 0; j < n_shift; ++j) {
      if (s_valid[j] && s_lo[j] <= d && d < s_hi[j])
        code = code == 254 ? s_bid[j] : (code | 128);
    }
    s_code[x] = (uint8_t)code;
  }
  __syncthreads();

  const int f = fill[b];
  for (int x = threadIdx.x; x < w; x += THREADS) {
    int src = -1;
    for (int j = n_shift - 1; j >= 0; --j) {
      if (!s_valid[j]) continue;
      int sx = (x - (j - s_neg)) % w;
      if (sx < 0) sx += w;
      const int iv = s_code[sx];
      const int bj = s_bid[j];
      if (iv == bj || iv == bj + 127 || iv == bj + 128) {
        src = sx;
        break;
      }
    }
    const bool cov = src >= 0;
    if (!cov) {
      src = (x - f) % w;
      if (src < 0) src += w;
    }
    uint8_t* dst = out + (row * w + x) * 3;
    dst[0] = s_rgb[src * 3 + 0];
    dst[1] = s_rgb[src * 3 + 1];
    dst[2] = s_rgb[src * 3 + 2];
    covered[row * w + x] = cov ? 1 : 0;
  }
}

}  // namespace

// img (B, H, W, 3) u8, depth (B, H, W) f32, lo/hi (B, S) f32, valid (B, S) u8,
// fill (B,) i32 -> out (B, H, W, 3) u8, covered (B, H, W) u8. All contiguous.
// Returns cudaGetLastError().
extern "C" int vrvg_warp_composite(const void* img, const void* depth,
                                   const void* lo, const void* hi,
                                   const void* valid, const void* fill,
                                   void* out, void* covered, int batch, int h,
                                   int w, int s_neg, int n_shift,
                                   void* stream) {
  const size_t smem = sizeof(float) * (size_t)(w + 2 * n_shift) +
                      sizeof(int) * (size_t)n_shift + 3 * (size_t)w;
  cudaError_t err = cudaFuncSetAttribute(
      warp_composite_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(h, batch);
  warp_composite_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (const float*)depth, (const float*)lo,
      (const float*)hi, (const uint8_t*)valid, (const int*)fill,
      (uint8_t*)out, (uint8_t*)covered, h, w, s_neg, n_shift);
  return (int)cudaGetLastError();
}

// The banded compositor: the same arguments as vrvg_warp_composite plus
// bid (B, S) i32, each valid shift's rank among the valid shifts. At most
// 126 shifts (the wrapper falls back to vrvg_warp_composite above that).
extern "C" int vrvg_warp_composite_banded(const void* img, const void* depth,
                                          const void* lo, const void* hi,
                                          const void* valid, const void* bid,
                                          const void* fill, void* out,
                                          void* covered, int batch, int h,
                                          int w, int s_neg, int n_shift,
                                          void* stream) {
  if (n_shift > 126) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(2 * n_shift) +
                      sizeof(int) * (size_t)(2 * n_shift) + 4 * (size_t)w;
  cudaError_t err = cudaFuncSetAttribute(
      warp_composite_banded_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(h, batch);
  warp_composite_banded_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (const float*)depth, (const float*)lo,
      (const float*)hi, (const uint8_t*)valid, (const int*)bid,
      (const int*)fill, (uint8_t*)out, (uint8_t*)covered, h, w, s_neg,
      n_shift);
  return (int)cudaGetLastError();
}
