// The SwiGLU half-block of the vitg (DINOv2-giant) blocks at f32
// (--compute_dtype float32), for Hopper (sm_90a): out = x + gamma *
// (w3(silu(x1) * x2) + b3), [x1 | x2] = w12(LN2(x)) + b12, as a chain of
// three launches on the caller's stream, as csrc/mlp_f32.cu runs rows 8 and
// 9 at f32:
//
//   1. row 1's f32 LayerNorm (csrc/layernorm.cu, vrvg_layernorm_f32):
//      x -> h, (M, D) f32;
//   2. gate: h w12^T on the 3xTF32 wgmma core (csrc/tf32x3_gemm.cuh, 128 x
//      128 tiles), w12 split with its rows in tf32x3::gated_row's order (a
//      tile's 128 columns are 64 hidden columns of x1 and the same 64 of
//      x2, which a wgmma accumulator's thread holds together), its epilogue
//      (tf32x3_gemm::SwigluGate) adding b12 to each f32 sum and taking
//      silu(x1) * x2: g, (M, H) f32;
//   3. down: g w3^T on the same core, its epilogue
//      tf32x3_gemm::LayerScaleResidual (+ b3, gamma * ., x + .): out, (M, D)
//      f32.
//
// The weights come split by vrvg_tf32x3_split (csrc/tf32x3_split.cu): w12
// gated (hidden = H), w3 plain; ops/mlp.tf32x3_weight keeps them with the
// weight, so a step splits nothing.
//
// Replaces: vr_video_generator_tpu/ops/mlp_pallas.py `_swiglu_kernel` (row
// 10, swiglu_residual_pallas) run at f32, at its rounding points: LN with
// f32 statistics and affine; each projection's f32 sum, + its bias; silu as
// jax.nn.silu on f32, 1 / (1 + exp(-x1)), then x1 * s, then the product
// with x2, every operation rounded on its own (expf without fast math, the
// IEEE division, no FMA: vrvg::silu_mul_f32, csrc/epilogue_f32.cuh); w3's
// f32 sum, + b3; gamma * y, then x + that. The TPU kernel sums w3 over
// 512-wide hidden blocks in an f32 accumulator, and this chain sums 32-wide
// stages of 3xTF32 products in f32: the products agree with f32 ones to
// about 2^-21 of |a||b| a term, and the sums differ in their order. x1 is
// rows [0, H) of w12 (jnp.split(t, 2)).
//
// What bounds it on the H100: at 1080p/vitg-518 (B = 8, M = 8 * 2443 =
// 19544, D = 1536, H = 4096) the two products are 737.7 GFLOP, 4.47 ms at
// 3xTF32's 165 TFLOP/s, against about 0.9 GB of f32 traffic (x, out, h and
// g written and read, the weights' hi and lo once: 0.27 ms at 3.35 TB/s):
// bound by operations. The gate output (M, H) f32 is scratch in device
// memory, 320 MB at vitg-518.
//
// vrvg_swiglu_gate_f32, the gate stage alone, exposes the epilogue for a
// check of its silu through a selection w12 (rows that pick one input
// column each, or none: every sum one product, hi(h) + lo(h) exactly,
// which chip_smoke.py's check feeds the plain silu).

#include "tf32x3_gemm.cuh"

extern "C" int vrvg_layernorm_f32(const void* x, const void* w,
                                  const void* b, void* y, int m, int d,
                                  float eps, void* stream);

// The gate stage: h (M, D) f32 LayerNorm'd rows, w12s (2H, D) split gated,
// b12 (2H,) f32 -> g (M, H) f32 = silu(h w12[:H]^T + b12[:H]) * (h
// w12[H:]^T + b12[H:]). D and H multiples of 4.
extern "C" int vrvg_swiglu_gate_f32(const void* h, const void* w12s,
                                    const void* b12, void* g, int m, int d,
                                    int hidden, void* stream) {
  if (d <= 0 || d % 4 || hidden <= 0 || hidden % 4) {
    return (int)cudaErrorInvalidValue;
  }
  return tf32x3_gemm::gemm(
      (const float*)h, (const uint32_t*)w12s, m, 2 * hidden, d, hidden,
      tf32x3_gemm::SwigluGate{hidden, (float*)g, (const float*)b12}, stream);
}

// Row 10 at f32: x (M, D) f32, LN affine (D,) f32, w12s (2H, D) split gated,
// b12 (2H,), w3s (D, H) split, b3 (D,), gamma (D,) f32; scratch h (M, D) and
// g (M, H) f32 -> out (M, D) f32. D and H multiples of 4 (the wrapper
// takes any D % 128 == 0 and zero-pads each half of H to a multiple of 64,
// the gated tile's 64 columns of x1 and of x2; silu(0) * 0 = 0 leaves that
// exact).
extern "C" int vrvg_swiglu_residual_f32(const void* x, const void* lnw,
                                        const void* lnb, const void* w12s,
                                        const void* b12, const void* w3s,
                                        const void* b3, const void* gamma,
                                        void* h, void* g, void* out, int m,
                                        int d, int hidden, float eps,
                                        void* stream) {
  if (d <= 0 || d % 4 || hidden <= 0 || hidden % 4) {
    return (int)cudaErrorInvalidValue;
  }
  int err = vrvg_layernorm_f32(x, lnw, lnb, h, m, d, eps, stream);
  if (err != 0) return err;
  err = vrvg_swiglu_gate_f32(h, w12s, b12, g, m, d, hidden, stream);
  if (err != 0) return err;
  return tf32x3_gemm::gemm(
      (const float*)g, (const uint32_t*)w3s, m, d, hidden, 0,
      tf32x3_gemm::LayerScaleResidual{d, (float*)out, (const float*)x,
                                      (const float*)b3, (const float*)gamma},
      stream);
}
