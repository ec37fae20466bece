// The f32 DPT tail's products on the SIMT f32 core (csrc/sgemm.cuh), for
// row 15 at f32 (csrc/head_tail_big.cu, vrvg_head_tail_f32): the A operand of a 3x3 convolution with zero padding
// read in place from a (B, H, W, C) f32 image (an implicit GEMM), the
// epilogue of output_conv2 -> ReLU -> 1x1 -> ReLU, and the tile each
// product runs on at each width (gemm_n, conv3x3, conv2_depth), which the
// tails' entry points and the CPU emulation (tests/test_torch_f32_emulation
// .py) share. Plain loads only, so the emulation runs them with the core.
// Rows 7, 11, 12 and 16 at f32 run their products on the 3xTF32 wgmma core
// instead (csrc/tf32x3_gemm.cuh).

#pragma once

#include "sgemm.cuh"

namespace {
namespace sgemm {

// A = the im2col of x (B, H, W, C) f32, contiguous, C a multiple of 4: row r
// = pixel (b, y, x) of the B H W, column k = (3 dh + dw) C + c, the tap (dh,
// dw) of channel c, zero outside the image (the conv's padding). A conv's
// weights (O, C, 3, 3) are B as (O, 9 C) in the same k order.
struct Conv3x3Rows {
  const float* x;
  int h, w, c, rows;  // rows = B H W
  struct Row {
    const float* p;  // the pixel's first channel; null past the rows
    int y, x;
  };
  __device__ __forceinline__ Row row(int r) const {
    if (r >= rows) return Row{nullptr, 0, 0};
    const int rem = r % (h * w), yy = rem / w;
    return Row{x + (long long)r * c, yy, rem - yy * w};
  }
  __device__ __forceinline__ float4 load4(const Row& r, int kk) const {
    if (r.p == nullptr || kk >= 9 * c) return make_float4(0.f, 0.f, 0.f, 0.f);
    const int tap = kk / c, ch = kk - tap * c;
    const int dh = tap / 3, dw = tap - 3 * dh;
    const int yy = r.y + dh - 1, xx = r.x + dw - 1;
    if (yy < 0 || yy >= h || xx < 0 || xx >= w)
      return make_float4(0.f, 0.f, 0.f, 0.f);
    return *reinterpret_cast<const float4*>(
        r.p + ((long long)(dh - 1) * w + (dw - 1)) * c + ch);
  }
};

// output_conv2's 32 sums of a pixel -> depth (vrvg::depth_out_f32: + b2,
// ReLU, the 1x1 (32 -> 1) in f32 in channel order, + b3, ReLU). A thread
// holds the pixel's whole row (Rows32).
struct DepthOut {
  float* out;  // (B H W,) f32
  const float* b2;
  const float* w3;
  const float* b3;
  template <class T>
  __device__ __forceinline__ void store(int row, int n0, int tx,
                                        const float (&v)[T::TN]) const {
    static_assert(T::BN == 32 && T::TN == 32, "a pixel's 32 sums a thread");
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[T::col(n0, tx, j)] = v[j];
    out[row] = vrvg::depth_out_f32(s, b2, w3, b3[0]);
  }
};

// C = epi(A B^T), B the (N, K) row-major f32 matrix w, on the tile that
// fits N: a whole 32-column row a thread at N = 32 (Rows32), 256 x 64 at N
// = 64 (Tall64), 128 x 128 above (Square; N = 192, conv1 at C = 384, has a
// half-empty second column tile). Row 15's conv1 (N = C2 = 32, 64) runs on
// it.
template <class OpA, class Epi>
int gemm_n(const OpA& a, const float* w, int m, int n, int k, const Epi& epi,
           void* stream) {
  const DenseRows b{w, k, n, k};
  switch (n) {
    case 32:
      return gemm<Rows32>(a, b, m, n, k, epi, stream);
    case 64:
      return gemm<Tall64>(a, b, m, n, k, epi, stream);
    default:
      return gemm<Square>(a, b, m, n, k, epi, stream);
  }
}

// A 3x3 convolution with zero padding of x (B, H, W, C) f32 by w (N, 9 C)
// f32, k = (3 dh + dw) C + c: epi on its (B H W, N) f32 sums.
template <class Epi>
int conv3x3(const float* x, const float* w, int batch, int h, int wd, int c,
            int n, const Epi& epi, void* stream) {
  const int m = batch * h * wd;
  return gemm_n(Conv3x3Rows{x, h, wd, c, m}, w, m, n, 9 * c, epi, stream);
}

// output_conv2 (32, 9 C2) f32 of R (B, H, W, C2) f32, + b2, ReLU, the 1x1
// and b3, ReLU -> out (B, H, W) f32 (DepthOut: a pixel's 32 sums a thread).
inline int conv2_depth(const float* r, const float* w2, const float* b2,
                       const float* w3, const float* b3, float* out,
                       int batch, int h, int wd, int c2, void* stream) {
  const int m = batch * h * wd;
  return gemm<Rows32>(Conv3x3Rows{r, h, wd, c2, m},
                      DenseRows{w2, 9 * c2, 32, 9 * c2}, m, 32, 9 * c2,
                      DepthOut{out, b2, w3, b3}, stream);
}

}  // namespace sgemm
}  // namespace
