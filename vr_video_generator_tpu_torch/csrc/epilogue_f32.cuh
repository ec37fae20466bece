// The per-element arithmetic of the f32 GEMM epilogues, one function per
// epilogue, called by both f32 GEMM cores: the SIMT core (csrc/sgemm.cuh,
// row 15 at f32) and the 3xTF32 wgmma core (csrc/tf32x3_gemm.cuh, rows 5,
// 6, 7, 8, 9, 10, 11, 12 and 16 at f32). Each takes a product's f32 sum
// and rounds every operation on its own (no FMA, no fast math), at the JAX
// package's f32 rounding points, so the two cores and the CPU emulation
// (tests/cuda_emu/cuda_runtime.h, which g++ compiles this header under:
// tests/test_torch_gemm_3xtf32.py, tests/test_torch_conv_3xtf32.py,
// tests/test_torch_conv_3xtf32_rcu_ext.py) share one copy of them.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "gelu_as.cuh"

namespace vrvg {

// fc1's epilogue of rows 8 and 9 at f32: GELU(s + b), the A&S GELU
// (gelu_as) or with TANH the tanh GELU (gelu_tanh_f32) on the rounded sum.
template <bool TANH>
__device__ __forceinline__ float bias_gelu_f32(float s, float b) {
  const float t = __fadd_rn(s, b);
  return TANH ? gelu_tanh_f32(t) : gelu_as(t);
}

// s + b, then with is_q that times scale: row 5's epilogue at f32 (the qkv
// product's sum + bias; q = f32(q) * scale, a no-op cast at f32).
__device__ __forceinline__ float qkv_f32(float s, float b, float scale,
                                         bool is_q) {
  const float t = __fadd_rn(s, b);
  return is_q ? __fmul_rn(t, scale) : t;
}

// x + gamma * (s + b): row 6's epilogue at f32 (proj + LayerScale +
// residual) and the down products' of rows 8, 9 and 10 (+ b2 or b3,
// LayerScale, residual).
__device__ __forceinline__ float ls_residual_f32(float s, float b, float g,
                                                 float x) {
  return __fadd_rn(x, __fmul_rn(g, __fadd_rn(s, b)));
}

// silu(x1) * x2 at f32, the rounding points of jax.nn.silu(t1) * t2 on f32
// (mlp_pallas.py `_swiglu_kernel`; ops/mlp.silu_mul): s = 1 / (1 +
// exp(-x1)), then x1 * s, then that times x2, each operation rounded on its
// own: expf without fast math, the IEEE division (past x1 < -88.7 exp
// overflows to inf and s is 0).
__device__ __forceinline__ float silu_mul_f32(float x1, float x2) {
  const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x1)));
  return __fmul_rn(__fmul_rn(x1, s), x2);
}

// Row 10's gate epilogue at f32: silu(s1 + b1) * (s2 + b2), s1 and s2 the
// sums of one hidden column's x1 and x2.
__device__ __forceinline__ float swiglu_gate_f32(float s1, float b1, float s2,
                                                 float b2) {
  return silu_mul_f32(__fadd_rn(s1, b1), __fadd_rn(s2, b2));
}

// A conv's f32 sum + its f32 bias: row 7's conv1 at f32
// (ops/head_tail.ext_conv1_plain) and row 15's.
__device__ __forceinline__ float bias_f32(float s, float b) {
  return __fadd_rn(s, b);
}

// A refinenet1 residual-unit conv's epilogue at f32, row 16
// (attic/refinenet_pre.rcu_conv_plain, `_rcu_pair_kernel`'s :92-121): s +
// b, with RELU a ReLU, then NRES residuals added in order (r0, then r1).
// The chain's kinds: RELU without residuals (conv1a, conv1b), two residuals
// (conv2a: rn0, path2), one (conv2b: t).
template <bool RELU, int NRES>
__device__ __forceinline__ float rcu_out_f32(float s, float b, float r0,
                                             float r1) {
  float o = __fadd_rn(s, b);
  if (RELU) o = fmaxf(o, 0.f);
  if (NRES > 0) o = __fadd_rn(o, r0);
  if (NRES > 1) o = __fadd_rn(o, r1);
  return o;
}

// The ReLU'd copy conv2a writes beside its output for conv1b: -0 and NaN
// become +0, as the bf16 chain's.
__device__ __forceinline__ float relu_copy_f32(float o) {
  return o > 0.f ? o : 0.f;
}

// output_conv2's epilogue at f32 (row 12's, and the back of rows 7 and 15):
// a pixel's 32 sums s in channel order -> ReLU(b3 + the 1x1 of ReLU(b2 +
// s)), the 1x1's terms w3 y added in channel order from 0
// (ops/head_tail.big_conv2_plain).
__device__ __forceinline__ float depth_out_f32(const float (&s)[32],
                                               const float* b2,
                                               const float* w3, float b3) {
  float sum = 0.f;
#pragma unroll
  for (int ch = 0; ch < 32; ++ch) {
    const float y = fmaxf(__fadd_rn(b2[ch], s[ch]), 0.f);
    sum = __fadd_rn(sum, __fmul_rn(y, w3[ch]));
  }
  return fmaxf(__fadd_rn(sum, b3), 0.f);
}

}  // namespace vrvg
