// Stereo forward-warp compositor, for Hopper (sm_90a).
//
// Replaces: vr_video_generator_tpu/ops/warp_pallas.py `_composite_prepacked`
// (kernel body `_warp_kernel`). For each shift s_j = j - s_neg of the
// frame's shift table (ascending j = far -> near on the TPU), output pixel x
// takes source pixel x - s_j (circular in x) when shift j is valid and
// lo[j] <= depth[x - s_j] < hi[j]; the last (largest) such j wins. Pixels no
// shift claims take the source pixel x - fill_offset and are reported as not
// covered.
//
// What bounds it on the H100: per 1080p frame it reads 8 MB of depth and
// 6 MB of RGB and writes 6 MB + 2 MB, ~0.18 GB per 8-frame batch, about
// 55 us at 3.35 TB/s. The TPU kernel rotated whole row blocks once per
// shift because Mosaic only rotates lanes. A walk over the shifts per
// output pixel (up to S = 69 at 1080p, 134 at 4K) costs each step a
// runtime `%`, a gather and two compares, every warp as slow as its
// longest walk.
//
// Design: the walk turned around. The winner at x is the largest
// valid j whose band holds depth[(x - s_j) mod w], so each SOURCE pixel sx
// checks its own depth against the shifts and, for each band it falls in,
// does atomicMax(win[(sx + s_j) mod w], j) on a row array in shared memory;
// the output pass reads win[x]: one gather, or the fill where nothing won.
// The (x, j) pairs are the walk's and max does not depend on order, so the
// result is exact and deterministic. A source pixel checks only the shifts
// its depth bin lists: each block builds, once per frame, a table of
// NB = 512 bins over the frame's finite band bounds [L, U], each bin a
// bitmask of the valid shifts whose band [lo, hi) meets it, widened by one
// bin on each side. bin(d) = clamp((d - L) * scale, 0, NB - 1) is monotone
// in d, so a depth inside a band always lies in one of its bins; no order
// of the bands is assumed, nor how many a depth falls in
// (ops/warp.py `warp_composite_scatter_plain` is the same algorithm in
// torch, held against the plain walk and the Pallas kernel on the CPU).
// Each shift's wrap s_j mod w is computed once, so the per-pixel work is a
// bin, a few mask words, and two compares and one shared atomic per
// candidate. Persistent blocks walk the rows of one frame; each row's depth
// and RGB are staged with 16-byte cp.async copies one row ahead (rowcopy.cuh),
// and the composite row and `covered` are staged in shared memory and
// written with 16-byte stores.
//
// The banded compositor (`warp_composite_banded_kernel`) replaces
// warp_pallas.py `_warp_kernel_banded`, the TPU's one-rotate-per-shift arm
// (`_composite_prepacked(banded=True)`, at most 126 shifts). That kernel
// gives each SOURCE pixel a code: the rank r (among the valid shifts,
// cumsum(valid) - valid) of the first valid band, in ascending j, that its
// own depth lies in, with bit 7 set when a later valid band holds it too;
// output pixel x takes shift j when the code at x - s_j is j's rank, or has
// bit 7 and is the rank before j's. So a pixel claims at most two shifts:
// rank r's and, with the bit, rank r + 1's, whichever band actually matched
// second (the next valid shift after rank r's; on tables where a depth lies
// in three bands, or in two bands that are not rank-adjacent, this is not
// what the classic kernel computes). A pixel in no band claims nothing.
// The kernel is row 3's with that scatter: the same staging, bin table and
// output pass; per pixel it finds the code from its bin's candidates with
// the same f32 lo <= d < hi compares in ascending j, then does
// atomicMax(win[(sx + s_j) mod w], j) for rank r's shift and, with the bit,
// for rank r + 1's, which the per-frame table holds as `next` (the shift
// of the next rank, -1 past the last). The winner is still the largest
// shift index j. ops/warp.py `warp_composite_banded_scatter_plain` is the
// same algorithm in torch, held against the TPU kernel's formulation on the
// CPU. The per-pixel work is the classic kernel's candidate walk, cut short
// at the second match, and at most two shared atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rowcopy.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NB = 512;  // depth bins (ops/warp.py WARP_BINS)

// Shared memory of the compositors, in bytes from the base: two slots each
// of the depth and RGB rows, the staged composite and covered rows, the
// winners, the bin masks and the per-shift tables.
struct WarpLayout {
  int depth_slot, rgb_slot, depth, rgb, out, cov, win, mask, table, total;
  __host__ __device__ WarpLayout(int w, int n_shift) {
    const int words = (n_shift + 31) / 32;
    depth_slot = vrvg::chunk_bytes(4 * w);
    rgb_slot = vrvg::chunk_bytes(3 * w);
    depth = 0;
    rgb = depth + 2 * depth_slot;
    out = rgb + 2 * rgb_slot;
    cov = out + vrvg::chunk_bytes(3 * w);
    win = cov + vrvg::chunk_bytes(w);
    mask = win + ((4 * w + 15) & ~15);
    table = mask + NB * words * 4;
    // lo, hi, wrap, kl, kh, next (S each) and the bin origin and scale
    total = table + ((24 * n_shift + 8 + 15) & ~15);
  }
};

// The bin of depth d (ops/warp.py depth_bins): monotone in d; NaN -> 0.
__device__ __forceinline__ int bin_of(float d, float origin, float scale) {
  const float t = __fmul_rn(__fsub_rn(d, origin), scale);
  return (int)fminf(fmaxf(t, 0.f), (float)(NB - 1));
}

// Shift j claims output pixel (sx + s_j) mod w for source pixel sx (wrap =
// s_j mod w): the largest claim wins.
__device__ __forceinline__ void claim(int* win, int sx, int wrap, int w,
                                      int j) {
  int x = sx + wrap;
  if (x >= w) x -= w;
  atomicMax(&win[x], j);
}

// Both compositors: BANDED picks row 14's scatter (a pixel claims its first
// band's shift and, when a later band holds it too, the next valid shift)
// over row 3's (every band that holds it).
template <bool BANDED>
__device__ __forceinline__ void composite_rows(
    const uint8_t* __restrict__ img, const float* __restrict__ depth,
    const float* __restrict__ lo, const float* __restrict__ hi,
    const uint8_t* __restrict__ valid, const int* __restrict__ fill,
    uint8_t* __restrict__ out, uint8_t* __restrict__ covered, int h, int w,
    int s_neg, int n_shift) {
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int words = (n_shift + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const WarpLayout L(w, n_shift);
  uint8_t* s_depth = smem + L.depth;
  uint8_t* s_rgb = smem + L.rgb;
  int* s_win = reinterpret_cast<int*>(smem + L.win);
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(smem + L.mask);
  float* s_lo = reinterpret_cast<float*>(smem + L.table);
  float* s_hi = s_lo + n_shift;
  int* s_wrap = reinterpret_cast<int*>(s_hi + n_shift);
  int* s_kl = s_wrap + n_shift;
  int* s_kh = s_kl + n_shift;
  int* s_next = s_kh + n_shift;  // the shift of the next rank (BANDED)
  float* s_bins = reinterpret_cast<float*>(s_next + n_shift);  // origin, scale

  const long long frame = (long long)b * h;
  const float* depth_row = depth + frame * w;
  const uint8_t* img_row = img + frame * w * 3;
  auto stage = [&](int y, int slot) {
    vrvg::load_chunks(s_depth + slot * L.depth_slot, depth_row + (long long)y * w,
                      4 * w, tid, THREADS);
    vrvg::load_chunks(s_rgb + slot * L.rgb_slot, img_row + (long long)y * w * 3,
                      3 * w, tid, THREADS);
  };
  const int y_first = blockIdx.x;
  const int y_step = gridDim.x;
  if (y_first < h) stage(y_first, 0);
  vrvg::cp_async_commit();

  // The frame's tables and candidate bins, while the first row arrives.
  const long long tab = (long long)b * n_shift;
  for (int j = tid; j < n_shift; j += THREADS) {
    s_lo[j] = lo[tab + j];
    s_hi[j] = hi[tab + j];
    int s = (j - s_neg) % w;
    s_wrap[j] = s < 0 ? s + w : s;
  }
  for (int x = tid; x < w; x += THREADS) s_win[x] = -1;
  __syncthreads();
  if (tid == 0) {
    float low = INFINITY, high = -INFINITY;
    for (int j = 0; j < n_shift; ++j) {
      if (!valid[tab + j]) continue;
      const float v[2] = {s_lo[j], s_hi[j]};
      for (int i = 0; i < 2; ++i) {
        if (isfinite(v[i])) {
          low = fminf(low, v[i]);
          high = fmaxf(high, v[i]);
        }
      }
    }
    const float span = __fsub_rn(high, low);
    const float scale = __fdiv_rn((float)NB, span);
    const bool ok = span > 0.f && isfinite(span) && isfinite(scale);
    s_bins[0] = ok ? low : 0.f;
    s_bins[1] = ok ? scale : 0.f;
    if constexpr (BANDED) {
      // Ranks ascend with j over the valid shifts, so rank r + 1's shift is
      // the next valid one after rank r's.
      int next = -1;
      for (int j = n_shift - 1; j >= 0; --j) {
        s_next[j] = next;
        if (valid[tab + j]) next = j;
      }
    }
  }
  __syncthreads();
  const float origin = s_bins[0], scale = s_bins[1];
  for (int j = tid; j < n_shift; j += THREADS) {
    const bool v = valid[tab + j] != 0;
    s_kl[j] = v ? max(bin_of(s_lo[j], origin, scale) - 1, 0) : 1;
    s_kh[j] = v ? min(bin_of(s_hi[j], origin, scale) + 1, NB - 1) : 0;
  }
  __syncthreads();
  for (int k = tid; k < NB; k += THREADS) {
    for (int wd = 0; wd < words; ++wd) {
      uint32_t bits = 0;
      for (int i = 0; i < 32; ++i) {
        const int j = wd * 32 + i;
        if (j < n_shift && s_kl[j] <= k && k <= s_kh[j]) bits |= 1u << i;
      }
      s_mask[k * words + wd] = bits;
    }
  }
  int fw = fill[b] % w;
  if (fw < 0) fw += w;

  // Row y's staged outputs sit at the alignment of their destinations.
  auto out_dst = [&](int y) { return out + (frame + y) * w * 3; };
  auto cov_dst = [&](int y) { return covered + (frame + y) * w; };
  auto store = [&](int y) {
    uint8_t* o = out_dst(y);
    uint8_t* c = cov_dst(y);
    vrvg::store_bytes(o, smem + L.out + vrvg::chunk_head(o), 3 * w, tid,
                      THREADS);
    vrvg::store_bytes(c, smem + L.cov + vrvg::chunk_head(c), w, tid, THREADS);
  };

  int slot = 0, prev = -1;
  for (int y = y_first; y < h; y += y_step) {
    vrvg::cp_async_wait<0>();
    __syncthreads();  // row y staged; the last row's output pass is done
    if (y + y_step < h) stage(y + y_step, slot ^ 1);
    vrvg::cp_async_commit();
    if (prev >= 0) store(prev);

    // Scatter: each source pixel's claims, by shift index.
    const float* d_row = reinterpret_cast<const float*>(
        s_depth + slot * L.depth_slot + vrvg::chunk_head(depth_row + (long long)y * w));
    for (int sx = tid; sx < w; sx += THREADS) {
      const float d = d_row[sx];
      const uint32_t* m = s_mask + bin_of(d, origin, scale) * words;
      if constexpr (!BANDED) {
        for (int wd = 0; wd < words; ++wd) {
          uint32_t bits = m[wd];
          while (bits) {
            const int j = wd * 32 + __ffs((int)bits) - 1;
            bits &= bits - 1;
            if (s_lo[j] <= d && d < s_hi[j]) claim(s_win, sx, s_wrap[j], w, j);
          }
        }
      } else {
        // The TPU kernel's code: the first band (ascending j) that holds d,
        // and whether a later one does too.
        int first = -1;
        bool dual = false;
        for (int wd = 0; wd < words && !dual; ++wd) {
          uint32_t bits = m[wd];
          while (bits) {
            const int j = wd * 32 + __ffs((int)bits) - 1;
            bits &= bits - 1;
            if (s_lo[j] <= d && d < s_hi[j]) {
              if (first >= 0) {
                dual = true;
                break;
              }
              first = j;
            }
          }
        }
        if (first >= 0) {
          claim(s_win, sx, s_wrap[first], w, first);
          const int second = dual ? s_next[first] : -1;
          if (second >= 0) claim(s_win, sx, s_wrap[second], w, second);
        }
      }
    }
    __syncthreads();

    // Output: the winner's source pixel, or the fill; reset the winners.
    const uint8_t* rgb = s_rgb + slot * L.rgb_slot +
                         vrvg::chunk_head(img_row + (long long)y * w * 3);
    uint8_t* o = smem + L.out + vrvg::chunk_head(out_dst(y));
    uint8_t* c = smem + L.cov + vrvg::chunk_head(cov_dst(y));
    for (int x = tid; x < w; x += THREADS) {
      const int j = s_win[x];
      s_win[x] = -1;
      int src = x - (j >= 0 ? s_wrap[j] : fw);
      if (src < 0) src += w;
      o[3 * x + 0] = rgb[3 * src + 0];
      o[3 * x + 1] = rgb[3 * src + 1];
      o[3 * x + 2] = rgb[3 * src + 2];
      c[x] = j >= 0 ? 1 : 0;
    }
    prev = y;
    slot ^= 1;
  }
  __syncthreads();
  if (prev >= 0) store(prev);
}

// Row 3's and row 14's kernels: the same body, the same arguments.
__global__ void __launch_bounds__(THREADS)
warp_composite_kernel(const uint8_t* __restrict__ img,
                      const float* __restrict__ depth,
                      const float* __restrict__ lo,
                      const float* __restrict__ hi,
                      const uint8_t* __restrict__ valid,
                      const int* __restrict__ fill, uint8_t* __restrict__ out,
                      uint8_t* __restrict__ covered, int h, int w, int s_neg,
                      int n_shift) {
  composite_rows<false>(img, depth, lo, hi, valid, fill, out, covered, h, w,
                        s_neg, n_shift);
}

__global__ void __launch_bounds__(THREADS)
warp_composite_banded_kernel(const uint8_t* __restrict__ img,
                             const float* __restrict__ depth,
                             const float* __restrict__ lo,
                             const float* __restrict__ hi,
                             const uint8_t* __restrict__ valid,
                             const int* __restrict__ fill,
                             uint8_t* __restrict__ out,
                             uint8_t* __restrict__ covered, int h, int w,
                             int s_neg, int n_shift) {
  composite_rows<true>(img, depth, lo, hi, valid, fill, out, covered, h, w,
                       s_neg, n_shift);
}

// Persistent blocks: as many as fit on the card at once, each walking the
// rows y = blockIdx.x, + gridDim.x, ... of one frame.
template <class Kernel>
int launch_composite(Kernel kernel, const void* img, const void* depth,
                     const void* lo, const void* hi, const void* valid,
                     const void* fill, void* out, void* covered, int batch,
                     int h, int w, int s_neg, int n_shift, void* stream) {
  const size_t smem = WarpLayout(w, n_shift).total;
  vrvg::LaunchLimits lim;
  cudaError_t err = vrvg::launch_limits(reinterpret_cast<const void*>(kernel),
                                        THREADS, smem, &lim);
  if (err != cudaSuccess) return (int)err;
  const int fit = lim.sms * lim.blocks_per_sm;
  const int per_frame = (fit + batch - 1) / batch;
  dim3 grid(per_frame < h ? per_frame : h, batch);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (const float*)depth, (const float*)lo,
      (const float*)hi, (const uint8_t*)valid, (const int*)fill,
      (uint8_t*)out, (uint8_t*)covered, h, w, s_neg, n_shift);
  return (int)cudaGetLastError();
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
  return launch_composite(warp_composite_kernel, img, depth, lo, hi, valid,
                          fill, out, covered, batch, h, w, s_neg, n_shift,
                          stream);
}

// The banded compositor: the same arguments as vrvg_warp_composite. At most
// 126 shifts (the wrapper falls back to vrvg_warp_composite above that).
extern "C" int vrvg_warp_composite_banded(const void* img, const void* depth,
                                          const void* lo, const void* hi,
                                          const void* valid, const void* fill,
                                          void* out, void* covered, int batch,
                                          int h, int w, int s_neg,
                                          int n_shift, void* stream) {
  if (n_shift > 126) return (int)cudaErrorInvalidValue;
  return launch_composite(warp_composite_banded_kernel, img, depth, lo, hi,
                          valid, fill, out, covered, batch, h, w, s_neg,
                          n_shift, stream);
}
