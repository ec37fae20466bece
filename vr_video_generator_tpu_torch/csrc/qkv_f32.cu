// The two ends of the fused attention half-block at f32, for Hopper
// (sm_90a): the f32 variants of csrc/qkv.cu's kernels, for
// --compute_dtype float32.
//
//   ln_qkv_f32:            x -> LN1 -> qkv GEMM -> + bias -> q * scale
//   proj_ls_residual_f32:  o -> proj GEMM -> + bias -> gamma * . -> x + .
//
// Replaces: vr_video_generator_tpu/ops/qkv_pallas.py `_ln_qkv_kernel`
// (ln_qkv_pallas, row 5) and `_proj_kernel` (proj_ls_residual_pallas, row
// 6) run at f32, where the JAX package plans them (qkv_pallas.attn_fusable:
// vits and vitb, not vitl's D = 1024 at f32). Rounding points as there at
// f32: LN with f32 statistics and affine; the GEMM's f32 sums, + bias; q =
// f32(q) * scale; gamma * y, then x + that. Each sum and product of the
// epilogues is an explicit __fadd_rn / __fmul_rn (csrc/epilogue_f32.cuh:
// vrvg::qkv_f32, vrvg::ls_residual_f32). The products are 3xTF32 sums: a
// fresh tensor-core sum a 32-wide stage of K, added into f32 running sums
// (csrc/tf32x3_gemm.cuh's header), so they agree with an f32 product to
// about 2^-21 of |a||b| a term and sum in another order than cuBLAS.
//
// Layout as csrc/qkv.cu's: ln_qkv writes the (M, 3D) product, i.e. (B, N,
// 3, H, 64), whose q, k and v slices the attention kernel reads as strided
// views; proj reads the attention output (B, N, H, 64) as (M, D).
//
// What bounds them on the H100: at 1080p/vits (M = 8 * 2443, D = 384)
// ln_qkv is 17.3 GFLOP, 0.105 ms at 3xTF32's 165 TFLOP/s (a third of the
// tensor cores' 495 TFLOP/s of TF32), against ~105 MB of f32 traffic
// (0.031 ms); proj is 5.8 GFLOP (0.035 ms) against ~91 MB (0.027 ms). At
// vitb-518 (D = 768) 69.2 and 23.1 GFLOP: 0.419 and 0.140 ms. Bound by
// operations.
//
// Design: ln_qkv is a chain of row 1's f32 LayerNorm (csrc/layernorm.cu,
// vrvg_layernorm_f32) into an (M, D) f32 scratch, then the 3xTF32 wgmma
// core's dense product (csrc/tf32x3_gemm.cuh gemm_kernel, 128 x 128 tiles)
// with the bias and q's scale in its epilogue (tf32x3_gemm::QkvScale); the
// JAX kernel fuses LN and product in one body, and the port keeps the
// chain, as at bf16 (csrc/qkv.cu). proj is one launch of the core with
// bias, LayerScale and the residual in its epilogue
// (tf32x3_gemm::LayerScaleResidual, which fc2 of rows 8 and 9 at f32
// shares, csrc/mlp_f32.cu). Each weight comes as the TF32 hi/lo planes
// that vrvg_tf32x3_split wrote, (2, Npad, K) (csrc/tf32x3_split.cu;
// ops/mlp.tf32x3_weight keeps them with the weight, so a step splits
// nothing). vrvg_qkv_f32 is the GEMM stage alone.

#include "tf32x3_gemm.cuh"

extern "C" int vrvg_layernorm_f32(const void* x, const void* w,
                                  const void* b, void* y, int m, int d,
                                  float eps, void* stream);

// Row 5's GEMM stage: a (M, D) f32 LayerNorm'd rows, ws (3D, D) split, b
// (3D,) f32 -> out (M, 3D) f32 = (B, N, 3, H, 64). D a multiple of 4.
extern "C" int vrvg_qkv_f32(const void* a, const void* ws, const void* b,
                            void* out, int m, int d, float scale,
                            void* stream) {
  return tf32x3_gemm::gemm(
      (const float*)a, (const uint32_t*)ws, m, 3 * d, d, 0,
      tf32x3_gemm::QkvScale{3 * d, (float*)out, (const float*)b, d, scale},
      stream);
}

// Row 5 at f32: x (M, D) f32, LN affine (D,) f32, ws (3D, D) split, b (3D,)
// f32; scratch a (M, D) f32 -> out (M, 3D) f32.
extern "C" int vrvg_ln_qkv_f32(const void* x, const void* lnw,
                               const void* lnb, const void* ws, const void* b,
                               void* a, void* out, int m, int d, float scale,
                               float eps, void* stream) {
  const int err = vrvg_layernorm_f32(x, lnw, lnb, a, m, d, eps, stream);
  if (err != 0) return err;
  return vrvg_qkv_f32(a, ws, b, out, m, d, scale, stream);
}

// Row 6 at f32: o (M, D) f32 (the attention output), x (M, D) f32 residual,
// ws (D, D) split, b (D,), gamma (D,) f32 -> out (M, D) f32 = x + gamma *
// (o w^T + b). D a multiple of 4.
extern "C" int vrvg_proj_ls_residual_f32(const void* o, const void* x,
                                         const void* ws, const void* b,
                                         const void* gamma, void* out, int m,
                                         int d, void* stream) {
  return tf32x3_gemm::gemm(
      (const float*)o, (const uint32_t*)ws, m, d, d, 0,
      tf32x3_gemm::LayerScaleResidual{d, (float*)out, (const float*)x,
                                      (const float*)b, (const float*)gamma},
      stream);
}
