// The f32 DPT tail's convolutions as implicit GEMMs on the f32 core
// (csrc/sgemm.cuh), for row 7 at f32 (csrc/head_tail_big.cu,
// vrvg_head_tail_ext_f32): the A operand of a 3x3 convolution with zero
// padding read in place from a (B, H, W, C) f32 image, and the epilogue of
// output_conv2 -> ReLU -> 1x1 -> ReLU. Plain loads only, so the CPU
// emulation (tests/test_torch_f32_emulation.py) runs them with the core.

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

// output_conv2's 32 sums of a pixel -> depth: + b2, ReLU, the 1x1 (32 -> 1)
// in f32 in channel order, + b3, ReLU (ops/head_tail.big_conv2_plain). A
// thread holds the pixel's whole row (Rows32).
struct DepthOut {
  float* out;  // (B H W,) f32
  const float* b2;
  const float* w3;
  const float* b3;
  template <class T>
  __device__ __forceinline__ void store(int row, int n0, int tx,
                                        const float (&v)[T::TN]) const {
    static_assert(T::BN == 32 && T::TN == 32, "a pixel's 32 sums a thread");
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int ch = T::col(n0, tx, j);
      const float y = fmaxf(__fadd_rn(b2[ch], v[j]), 0.f);
      sum = __fadd_rn(sum, __fmul_rn(y, w3[ch]));
    }
    out[row] = fmaxf(__fadd_rn(sum, b3[0]), 0.f);
  }
};

}  // namespace sgemm
}  // namespace
