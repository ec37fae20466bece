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
// 1080p frame (~0.2 GB per 8-frame batch, ~65 us at 3.35 TB/s). The blur
// is (11 + 9) * 3 multiplies and adds per pixel where every pixel is
// blurred, ~1.6 G a batch.
//
// Design: one thread per pair of neighbouring pixel columns (TW = 128
// threads a block), walking down a run of rows of one frame, the runs as
// long as lets every block of the launch be resident at once. Each input
// row is read once from device memory (a run's 2 ks halo rows are its
// only re-read): the rows AHEAD positions on are prefetched into L2, a
// warp's taps are neighbouring bytes, and a row's taps after the first
// are L1 hits. The pair shares its kx + 1 tap pixels, each read and
// converted to f32 (by its bits, no int-to-float conversion) once. Each
// thread keeps its pixels' horizontal sums for the ky rows that read them
// in registers (the window is a template parameter, kernel_size 0 to 16,
// up to 4320p), so each row's horizontal pass runs once, and the kernel
// needs no shared memory and no barrier. The taps are passed by value (the
// constant bank). Blur work is done only where a hole is within reach: a
// bit history of the holes (uncovered, at or past the edge) of each pixel
// decides whether a row's horizontal pass runs and whether a pixel's
// vertical pass does.
//
// What bounds it: the walk's latency. At 1080p, B = 8 each thread walks
// ~143 rows (4 blocks of 128 threads an SM at 128 registers), and each of
// its bytes moves by one load or store of its own (gemm_bench --rows 4).
// Designs that staged rows in shared memory with cp.async (a barrier a
// step of 1 or 4 rows, or one ring a warp), one pixel a thread, or the
// window in shared memory were slower on an H100 (PERF.md): each staged
// step's bookkeeping, paid by every thread for one byte a row, kept the
// SM's issue slots busy, or their registers kept occupancy low. Capping
// registers spills and loses.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "rowcopy.cuh"  // launch_limits, prefetch_l2

namespace {

constexpr int TW = 128;     // pixel columns per block
constexpr int KS_MAX = 16;  // kernel_size = round(0.0036 H): to 4320p
constexpr int AHEAD = 8;    // rows prefetched into L2 ahead of the walk

// A byte as f32, exactly, by its bits (no int-to-float conversion).
__device__ __forceinline__ float u8f(uint32_t v) {
  return __fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.f);
}

__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

__device__ __forceinline__ uint32_t pack3(const uint8_t* v) {
  return (uint32_t)v[0] | ((uint32_t)v[1] << 8) | ((uint32_t)v[2] << 16);
}

// The blur taps, passed by value: they live in the constant bank, not in
// each thread's registers.
struct Taps {
  float x[2 * KS_MAX + 3], y[2 * KS_MAX + 1];
};

// One thread per pair of pixel columns x, x + 1 of a run of rows y0 .. y0 +
// n_out - 1 of one frame; the pair shares its taps. Position p is the row
// y0 - KS + p of the run or its halo, reflected at the frame's edges;
// output j = p - 2 KS is complete once position p's horizontal sums are in
// the window.
template <bool PACKED, int KS>
__global__ void __launch_bounds__(TW)
blur_select_sbs_kernel(const uint8_t* __restrict__ comp,
                       const uint8_t* __restrict__ covered,
                       const uint8_t* __restrict__ orig,
                       const int* __restrict__ edge, const Taps taps,
                       void* __restrict__ out, int h, int w, int rows) {
  constexpr int KX = 2 * KS + 3, KY = 2 * KS + 1, PX = KS + 1, PY = KS;
  constexpr int NT = KX + 1;  // tap pixels of the pair
  const int x = 2 * (blockIdx.x * TW + threadIdx.x);
  if (x >= w) return;
  const int np = min(2, w - x);  // pixels of this pair inside the frame
  const int y0 = blockIdx.y * rows;
  const int n_out = min(h - y0, rows);
  const int n_pos = n_out + 2 * PY;
  const long long plane = (long long)blockIdx.z * h * w;
  const uint8_t* comp_f = comp + plane * 3;
  const uint8_t* cov_x = covered + plane + x;
  const uint8_t* orig_x = orig + (plane + x) * 3;
  const int e = edge[blockIdx.z];
  // Pairs whose taps all lie in the row read them at fixed offsets from
  // their first; the others reflect each tap.
  const bool interior = x >= PX && x + 1 + PX < w;
  auto comp_row = [&](int p) {
    return comp_f + (long long)min(max(reflect(y0 - PY + p, h), 0), h - 1) * w * 3;
  };

  float hb[2][3][KY];  // the pair's horizontal sums, positions p - 2KS .. p
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int t = 0; t < KY; ++t) hb[q][i][t] = 0.f;
  // Bit i of holes[q]: output p - i is a hole at pixel x + q.
  uint64_t holes[2] = {0, 0};
  constexpr uint64_t REACH = (uint64_t(2) << (2 * PY)) - 1;  // p - 2KS .. p
#pragma unroll 2
  for (int p = 0; p < n_pos; ++p) {
    const int pa = p + AHEAD;
    if (pa < n_pos) {
      vrvg::prefetch_l2(comp_row(pa) + 3 * x);
      if (pa < n_out) vrvg::prefetch_l2(cov_x + (long long)(y0 + pa) * w);
      if (pa >= 2 * PY && pa - 2 * PY < n_out)
        vrvg::prefetch_l2(orig_x + (long long)(y0 + pa - 2 * PY) * w * 3);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const bool hole = q < np && x + q >= e && p < n_out &&
                        cov_x[(long long)(y0 + p) * w + q] == 0;
      holes[q] = (holes[q] << 1) | (hole ? 1 : 0);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int t = 0; t + 1 < KY; ++t) hb[q][i][t] = hb[q][i][t + 1];
    }
    if ((holes[0] | holes[1]) & REACH) {  // a hole within reach
      const uint8_t* row = comp_row(p);
      const uint8_t* first = row + 3 * (x - PX);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float acc[2] = {0.f, 0.f};
        float v[NT];
#pragma unroll
        for (int t = 0; t < NT; ++t)
          v[t] = u8f(__ldg(interior ? first + 3 * t + i
                                    : row + 3 * reflect(x - PX + t, w) + i));
#pragma unroll
        for (int t = 0; t < KX; ++t) {
          acc[0] = __fadd_rn(acc[0], __fmul_rn(taps.x[t], v[t]));
          acc[1] = __fadd_rn(acc[1], __fmul_rn(taps.x[t], v[t + 1]));
        }
        hb[0][i][KY - 1] = acc[0];
        hb[1][i][KY - 1] = acc[1];
      }
    }
    const int j = p - 2 * PY;
    if (j < 0) continue;
    const long long px = (long long)(y0 + j) * w;
    const uint8_t* o = orig_x + px * 3;
    const uint8_t* src = comp_f + (px + x) * 3;
    uint8_t left[2][3], right[2][3];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const bool j_hole = (holes[q] >> (2 * PY)) & 1;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (q >= np) {
          left[q][i] = right[q][i] = 0;
          continue;
        }
        right[q][i] = __ldg(o + 3 * q + i);
        if (x + q < e) {
          left[q][i] = right[q][i];
        } else if (!j_hole) {
          left[q][i] = __ldg(src + 3 * q + i);
        } else {
          float acc = 0.f;
#pragma unroll
          for (int t = 0; t < KY; ++t)
            acc = __fadd_rn(acc, __fmul_rn(taps.y[t], hb[q][i][t]));
          left[q][i] = (uint8_t)fminf(fmaxf(rintf(acc), 0.f), 255.f);
        }
      }
    }
    const long long out_px = plane * 2 + (long long)(y0 + j) * 2 * w + x;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q >= np) break;
      if (PACKED) {
        uint32_t* d = static_cast<uint32_t*>(out) + out_px + q;
        d[0] = pack3(left[q]);
        d[w] = pack3(right[q]);
      } else {
        uint8_t* d = static_cast<uint8_t*>(out) + (out_px + q) * 3;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          d[i] = left[q][i];
          d[3 * w + i] = right[q][i];
        }
      }
    }
  }
}

template <bool PACKED, int KS>
int run(const void* comp, const void* covered, const void* orig,
        const void* edge, const Taps& taps, void* out, int batch, int h,
        int w, void* stream) {
  vrvg::LaunchLimits lim;
  cudaError_t err = vrvg::launch_limits(
      reinterpret_cast<const void*>(blur_select_sbs_kernel<PACKED, KS>), TW,
      0, &lim);
  if (err != cudaSuccess) return (int)err;
  // Runs of rows as long as lets every block of the launch be resident at
  // once: the 2 ks halo rows of a run are its only rows read twice.
  const int strips = (w + 2 * TW - 1) / (2 * TW);
  int runs = lim.sms * lim.blocks_per_sm / (strips * batch);
  runs = runs < 1 ? 1 : (runs > h ? h : runs);
  const int rows = (h + runs - 1) / runs;
  dim3 grid(strips, (h + rows - 1) / rows, batch);
  blur_select_sbs_kernel<PACKED, KS><<<grid, TW, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const uint8_t*)covered, (const uint8_t*)orig,
      (const int*)edge, taps, out, h, w, rows);
  return (int)cudaGetLastError();
}

template <bool PACKED>
int run_ks(const void* comp, const void* covered, const void* orig,
           const void* edge, const Taps& taps, void* out, int batch, int h,
           int w, int ks, void* stream) {
  switch (ks) {
#define VRVG_KS(v)                                                         \
  case v:                                                                  \
    return run<PACKED, v>(comp, covered, orig, edge, taps, out, batch, h, \
                          w, stream);
    VRVG_KS(0) VRVG_KS(1) VRVG_KS(2) VRVG_KS(3) VRVG_KS(4) VRVG_KS(5)
    VRVG_KS(6) VRVG_KS(7) VRVG_KS(8) VRVG_KS(9) VRVG_KS(10) VRVG_KS(11)
    VRVG_KS(12) VRVG_KS(13) VRVG_KS(14) VRVG_KS(15) VRVG_KS(16)
#undef VRVG_KS
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// comp/orig (B, H, W, 3) u8, covered (B, H, W) u8, edge (B,) i32 on the
// device; kxw (kx,) and kyw (ky,) f32 in host memory, copied into the
// launch; -> out (B, H, 2W, 3) u8, or with `packed` (B, H, 2W) uint32
// words. kx = 2 ks + 3 and ky = 2 ks + 1 with ks <= 16. All contiguous.
// Returns cudaGetLastError().
extern "C" int vrvg_blur_select_sbs(const void* comp, const void* covered,
                                    const void* orig, const void* edge,
                                    const void* kxw, const void* kyw,
                                    void* out, int batch, int h, int w,
                                    int kx, int ky, int packed, void* stream) {
  const int ks = ky / 2;
  if (kx != 2 * ks + 3 || ky != 2 * ks + 1 || ks > KS_MAX)
    return (int)cudaErrorInvalidValue;
  Taps taps = {};
  memcpy(taps.x, kxw, sizeof(float) * kx);
  memcpy(taps.y, kyw, sizeof(float) * ky);
  return packed ? run_ks<true>(comp, covered, orig, edge, taps, out, batch,
                               h, w, ks, stream)
                : run_ks<false>(comp, covered, orig, edge, taps, out, batch,
                                h, w, ks, stream);
}
