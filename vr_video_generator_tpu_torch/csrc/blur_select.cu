// Gaussian hole fill, hole select, left-edge copy and SBS concat, for Hopper
// (sm_90a).
//
// Replaces: vr_video_generator_tpu/ops/warp_pallas.py `blur_select_pallas`
// (kernel body `_blur_select_kernel`) together with the XLA epilogue that
// follows it on the u8 path (warp_pallas.py `warp_batch_pallas`, the edge
// copy and the [synth | original] concat), as the TPU's packed kernel
// `_blur_select_sbs_kernel` already does.
//
// The packed emit replaces warp_pallas.py `_blur_select_sbs_kernel`
// (blur_select_sbs_pallas, the `emit="packed"` path of warp_batch_pallas):
// the same pixels written as uint32 words r | g<<8 | b<<16 with the top byte
// zero, (B, H, 2W). The kernel is templated on the emit: only its last
// stores differ, and the packed output moves 8 bytes a pixel pair where the
// u8 one moves 6.
//
// Semantics (torchvision gaussian_blur on the composite, ops/gaussian.py):
// reflect padding, the horizontal pass (kx = 2k+3 taps) then the vertical
// pass (ky = 2k+1 taps), each an f32 sum with the taps in ascending order
// starting from 0, then round-half-even and clip to [0, 255]. Covered pixels
// keep the composite, the rest take the blur, columns x < edge_width take the
// original frame, and the right half of the output row is the original.
// __fmul_rn/__fadd_rn keep nvcc from contracting to FMA, so the sums round
// exactly as the plain version's separate multiplies and adds do.
//
// What bounds it on the H100: it reads 6 + 2 + 6 MB and writes 12 MB per
// 1080p frame (~0.2 GB per 8-frame batch, ~60 us at 3.35 TB/s) and does
// (11 + 9) * 3 multiply-adds per pixel (~2.5 GFLOP per batch), so it sits
// near the balance point. Each input pixel is loaded once per tile into
// shared memory, so the blur's taps are re-read from shared memory, not
// from device memory.
//
// Design: one block per (64-column, 16-row) tile of one frame. The tile and
// its reflect halo are gathered into shared memory as f32 (reflect indexing
// in the kernel, no padded copy), the horizontal pass fills a second
// shared buffer, and the vertical pass plus the select/edge/concat epilogue
// write the final (B, H, 2W, 3) u8 rows.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TW = 64;  // output columns per block
constexpr int TH = 16;  // output rows per block
constexpr int THREADS = 256;

__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  // Halo positions of a ragged last tile may fall outside even the mirror;
  // they feed no output pixel, so clamp them into bounds.
  return min(max(i, 0), n - 1);
}

template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
blur_select_sbs_kernel(const uint8_t* __restrict__ comp,
                       const uint8_t* __restrict__ covered,
                       const uint8_t* __restrict__ orig,
                       const int* __restrict__ edge,
                       const float* __restrict__ kxw,
                       const float* __restrict__ kyw,
                       void* __restrict__ out, int h, int w, int kx,
                       int ky) {
  const int px = kx / 2;
  const int py = ky / 2;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int b = blockIdx.z;
  const int in_w = TW + 2 * px;
  const int in_h = TH + 2 * py;

  extern __shared__ __align__(16) float smem[];
  float* s_kx = smem;
  float* s_ky = s_kx + kx;
  float* s_in = s_ky + ky;            // in_h * in_w * 3
  float* s_hb = s_in + in_h * in_w * 3;  // in_h * TW * 3

  for (int i = threadIdx.x; i < kx; i += THREADS) s_kx[i] = kxw[i];
  for (int i = threadIdx.x; i < ky; i += THREADS) s_ky[i] = kyw[i];
  const long long frame = (long long)b * h;
  for (int i = threadIdx.x; i < in_h * in_w; i += THREADS) {
    const int r = i / in_w;
    const int c = i % in_w;
    const int gy = reflect(y0 + r - py, h);
    const int gx = reflect(x0 + c - px, w);
    const uint8_t* p = comp + ((frame + gy) * w + gx) * 3;
    s_in[i * 3 + 0] = (float)p[0];
    s_in[i * 3 + 1] = (float)p[1];
    s_in[i * 3 + 2] = (float)p[2];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < in_h * TW; i += THREADS) {
    const int r = i / TW;
    const int c = i % TW;
    const float* src = s_in + (r * in_w + c) * 3;
    for (int ch = 0; ch < 3; ++ch) {
      float acc = 0.f;
      for (int t = 0; t < kx; ++t) {
        acc = __fadd_rn(acc, __fmul_rn(s_kx[t], src[t * 3 + ch]));
      }
      s_hb[i * 3 + ch] = acc;
    }
  }
  __syncthreads();

  const int e = edge[b];
  for (int i = threadIdx.x; i < TH * TW; i += THREADS) {
    const int r = i / TW;
    const int c = i % TW;
    const int y = y0 + r;
    const int x = x0 + c;
    if (y >= h || x >= w) continue;
    const long long pix = (frame + y) * w + x;
    const uint8_t* o = orig + pix * 3;
    uint8_t left[3];
    if (x < e) {
      left[0] = o[0];
      left[1] = o[1];
      left[2] = o[2];
    } else if (covered[pix]) {
      left[0] = comp[pix * 3 + 0];
      left[1] = comp[pix * 3 + 1];
      left[2] = comp[pix * 3 + 2];
    } else {
      for (int ch = 0; ch < 3; ++ch) {
        float acc = 0.f;
        for (int t = 0; t < ky; ++t) {
          acc = __fadd_rn(acc, __fmul_rn(s_ky[t], s_hb[((r + t) * TW + c) * 3 + ch]));
        }
        left[ch] = (uint8_t)fminf(fmaxf(rintf(acc), 0.f), 255.f);
      }
    }
    const long long opix = (frame + y) * 2 * w + x;
    if (PACKED) {
      uint32_t* dst = static_cast<uint32_t*>(out) + opix;
      dst[0] = (uint32_t)left[0] | ((uint32_t)left[1] << 8) |
               ((uint32_t)left[2] << 16);
      dst[w] = (uint32_t)o[0] | ((uint32_t)o[1] << 8) | ((uint32_t)o[2] << 16);
    } else {
      uint8_t* dst = static_cast<uint8_t*>(out) + opix * 3;
      dst[0] = left[0];
      dst[1] = left[1];
      dst[2] = left[2];
      dst[3 * w + 0] = o[0];
      dst[3 * w + 1] = o[1];
      dst[3 * w + 2] = o[2];
    }
  }
}

template <bool PACKED>
int run(const void* comp, const void* covered, const void* orig,
        const void* edge, const void* kxw, const void* kyw, void* out,
        int batch, int h, int w, int kx, int ky, void* stream) {
  const int px = kx / 2;
  const int py = ky / 2;
  const size_t smem =
      sizeof(float) * ((size_t)kx + ky + (size_t)(TH + 2 * py) * (TW + 2 * px) * 3 +
                       (size_t)(TH + 2 * py) * TW * 3);
  cudaError_t err = cudaFuncSetAttribute(
      blur_select_sbs_kernel<PACKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, batch);
  blur_select_sbs_kernel<PACKED><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const uint8_t*)covered, (const uint8_t*)orig,
      (const int*)edge, (const float*)kxw, (const float*)kyw, out, h, w, kx,
      ky);
  return (int)cudaGetLastError();
}

}  // namespace

// comp/orig (B, H, W, 3) u8, covered (B, H, W) u8, edge (B,) i32, kxw (kx,)
// and kyw (ky,) f32 -> out (B, H, 2W, 3) u8, or with `packed` (B, H, 2W)
// uint32 words. All contiguous. Returns cudaGetLastError().
extern "C" int vrvg_blur_select_sbs(const void* comp, const void* covered,
                                    const void* orig, const void* edge,
                                    const void* kxw, const void* kyw,
                                    void* out, int batch, int h, int w,
                                    int kx, int ky, int packed, void* stream) {
  return packed ? run<true>(comp, covered, orig, edge, kxw, kyw, out, batch,
                            h, w, kx, ky, stream)
                : run<false>(comp, covered, orig, edge, kxw, kyw, out, batch,
                             h, w, kx, ky, stream);
}
