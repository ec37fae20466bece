// Resize taps and conv-weight staging shared by the DPT tail kernels
// (csrc/head_tail.cu, csrc/head_tail_big.cu): the H-resizes as exact integer
// align-corners taps with an f32 fraction and an f32 lerp, and the two-tap
// W-resize, with every product and sum rounded on its own (no FMA), as the
// TPU kernels compute them (vr_video_generator_tpu/ops/head_tail_pallas.py
// `_lerp_taps`).

#pragma once

#include "gemm.cuh"

namespace vrvg {

// Exact bilinear align-corners taps of output row r of an n_in -> n_out
// resize (head_tail_pallas._lerp_taps): rows i0, i1 and the f32 fraction.
struct Taps {
  int i0, i1;
  float t, omt;
};

__device__ __forceinline__ Taps lerp_taps(int r, int n_in, int n_out) {
  Taps k;
  if (n_out == 1) {
    k.i0 = k.i1 = 0;
    k.t = 0.f;
  } else {
    const long long num = (long long)r * (n_in - 1);
    const long long h0 = num / (n_out - 1);
    k.i0 = (int)h0;
    k.i1 = min((int)h0 + 1, n_in - 1);
    k.t = __fdiv_rn((float)(num - h0 * (n_out - 1)), (float)(n_out - 1));
  }
  k.omt = __fsub_rn(1.f, k.t);
  return k;
}

__device__ __forceinline__ float lerp(const Taps& k, float a, float b) {
  return __fadd_rn(__fmul_rn(k.omt, a), __fmul_rn(k.t, b));
}

// W-resize of 8 channels: fl(wa * a + wb * b) per channel, cast to bf16.
__device__ __forceinline__ void wlerp8(bf16* dst, const bf16* a, const bf16* b,
                                       float wa, float wb) {
#pragma unroll
  for (int e = 0; e < 8; ++e)
    dst[e] = rbf(__fadd_rn(__fmul_rn(wa, bf(a[e])), __fmul_rn(wb, bf(b[e]))));
}

// The element types of the tail's passes (bf16, and f32 for the f32 ext
// tail): to f32 for the arithmetic, and the rounding back.
__device__ __forceinline__ float to_f32(bf16 v) { return bf(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return rbf(v);
}
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// W-resize of N channels of element type T: fl(wa * a + wb * b) per
// channel, rounded to T (wlerp8's arithmetic at bf16).
template <class T, int N>
__device__ __forceinline__ void wlerp(T* dst, const T* a, const T* b,
                                      float wa, float wb) {
#pragma unroll
  for (int e = 0; e < N; ++e)
    dst[e] = from_f32<T>(__fadd_rn(__fmul_rn(wa, to_f32(a[e])),
                                   __fmul_rn(wb, to_f32(b[e]))));
}

// Rows [kc, kc + kcn) of each tap of (9, cin, ld) 3x3 conv weights, columns
// [0, cols) of `wt` (pre-offset to the first column), into shared memory as
// (9, kcn, cols).
__device__ __forceinline__ void load_taps(bf16* Wt, const bf16* wt,
                                          long long ld, int cin, int kc,
                                          int kcn, int cols) {
#pragma unroll 1
  for (int t = 0; t < 9; ++t)
    load_rows(Wt + t * kcn * cols, cols, wt + ((long long)t * cin + kc) * ld,
              ld, kcn, cols, kcn, threadIdx.x, blockDim.x);
}

}  // namespace vrvg
