// The SwiGLU half-block of the vitg (DINOv2-giant) blocks at f32
// (--compute_dtype float32), for Hopper (sm_90a): out = x + gamma *
// (w3(silu(x1) * x2) + b3), [x1 | x2] = w12(LN2(x)) + b12, as a chain of
// three launches on the caller's stream, as csrc/mlp_f32.cu runs rows 8 and
// 9 at f32:
//
//   1. row 1's f32 LayerNorm (csrc/layernorm.cu, vrvg_layernorm_f32):
//      x -> h, (M, D) f32;
//   2. gate: h w12^T on the f32 GEMM core (csrc/sgemm.cuh, 128 x 128
//      tiles), w12 read in its upstream (2H, D) layout as the gated operand
//      sgemm::GatedRows (a tile's 128 columns are 64 columns of x1 and the
//      same 64 of x2), its epilogue (sgemm::SwigluGate) adding b12 to each
//      f32 sum and taking silu(x1) * x2: g, (M, H) f32;
//   3. down: g w3^T on the same core, its epilogue sgemm::LayerScaleResidual
//      (+ b3, gamma * ., x + .): out, (M, D) f32.
//
// Replaces: vr_video_generator_tpu/ops/mlp_pallas.py `_swiglu_kernel` (row
// 10, swiglu_residual_pallas) run at f32, at its rounding points: LN with
// f32 statistics and affine; each projection's f32 sum, + its bias; silu as
// jax.nn.silu on f32, 1 / (1 + exp(-x1)), then x1 * s, then the product
// with x2, every operation rounded on its own (expf without fast math, the
// IEEE division, no FMA: sgemm::silu_mul_f32); w3's f32 sum, + b3; gamma *
// y, then x + that. The TPU kernel sums w3 over 512-wide hidden blocks in
// an f32 accumulator and this chain over all of H at once: only the order
// of the f32 sums differs. x1 is rows [0, H) of w12 (jnp.split(t, 2)).
//
// What bounds it on the H100: at 1080p/vitg-518 (B = 8, M = 8 * 2443 =
// 19544, D = 1536, H = 4096) the two products are 737.7 GFLOP, 11.0 ms at
// the card's 67 TFLOP/s f32 rate outside the tensor cores, against about
// 0.8 GB of f32 traffic (x, out, h and g written and read, the weights
// once: 0.25 ms at 3.35 TB/s): bound by operations, since wgmma takes no
// f32 operands and TF32 is not f32 (csrc/sgemm.cuh's header). The gate
// output (M, H) f32 is scratch in device memory, 320 MB at vitg-518.
//
// vrvg_swiglu_gate_f32, the gate stage alone, exposes the epilogue for a
// check of its silu bit for bit through a selection w12 (rows that pick one
// input column each, or none: every sum one exact product) and for the CPU
// emulation of the chain (tests/test_torch_f32_emulation.py).

#include "sgemm.cuh"

extern "C" int vrvg_layernorm_f32(const void* x, const void* w,
                                  const void* b, void* y, int m, int d,
                                  float eps, void* stream);

// The gate stage: h (M, D) f32 LayerNorm'd rows, w12 (2H, D), b12 (2H,) f32
// -> g (M, H) f32 = silu(h w12[:H]^T + b12[:H]) * (h w12[H:]^T + b12[H:]).
// D and H multiples of 4.
extern "C" int vrvg_swiglu_gate_f32(const void* h, const void* w12,
                                    const void* b12, void* g, int m, int d,
                                    int hidden, void* stream) {
  if (d <= 0 || d % 4 || hidden <= 0 || hidden % 4) {
    return (int)cudaErrorInvalidValue;
  }
  const int n = 128 * ((hidden + 63) / 64);
  return sgemm::gemm<sgemm::Square>(
      sgemm::DenseRows{(const float*)h, d, m, d},
      sgemm::GatedRows{(const float*)w12, hidden, d}, m, n, d,
      sgemm::SwigluGate{(float*)g, (const float*)b12, hidden}, stream);
}

// Row 10 at f32: x (M, D) f32, LN affine (D,) f32, w12 (2H, D), b12 (2H,),
// w3 (D, H), b3 (D,), gamma (D,) f32; scratch h (M, D) and g (M, H) f32 ->
// out (M, D) f32. D and H multiples of 4 (the port takes D = 1536, H =
// 4096).
extern "C" int vrvg_swiglu_residual_f32(const void* x, const void* lnw,
                                        const void* lnb, const void* w12,
                                        const void* b12, const void* w3,
                                        const void* b3, const void* gamma,
                                        void* h, void* g, void* out, int m,
                                        int d, int hidden, float eps,
                                        void* stream) {
  if (d <= 0 || d % 4 || hidden <= 0 || hidden % 4) {
    return (int)cudaErrorInvalidValue;
  }
  int err = vrvg_layernorm_f32(x, lnw, lnb, h, m, d, eps, stream);
  if (err != 0) return err;
  err = vrvg_swiglu_gate_f32(h, w12, b12, g, m, d, hidden, stream);
  if (err != 0) return err;
  return sgemm::gemm<sgemm::Square>(
      sgemm::DenseRows{(const float*)g, hidden, m, hidden},
      sgemm::DenseRows{(const float*)w3, hidden, d, hidden}, m, d, hidden,
      sgemm::LayerScaleResidual{(float*)out, (const float*)x,
                                (const float*)b3, (const float*)gamma, d},
      stream);
}
