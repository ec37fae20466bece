// The MLP half-block of the DINOv2 blocks with a GELU MLP at f32
// (--compute_dtype float32), for Hopper (sm_90a): out = x + gamma *
// (fc2(GELU(fc1(LN2(x))))), hidden 4D, as a chain of three launches on the
// caller's stream:
//
//   1. row 1's f32 LayerNorm (csrc/layernorm.cu, vrvg_layernorm_f32):
//      x -> a, (M, D) f32;
//   2. fc1 on the 3xTF32 wgmma core (csrc/tf32x3_gemm.cuh, 128 x 128
//      tiles), its epilogue (tf32x3_gemm::BiasGelu) adding b1 to the f32
//      sum and taking the GELU (the A&S form of csrc/gelu_as.cuh, or with
//      `approx` the tanh form) on it: h, (M, 4D) f32;
//   3. fc2 on the same core, its epilogue (tf32x3_gemm::LayerScaleResidual)
//      + b2, gamma * ., x + .: out, (M, D) f32.
//
// The weights come split: w1 and w2 as the TF32 hi/lo planes that
// vrvg_tf32x3_split wrote (csrc/tf32x3_split.cu; ops/mlp.tf32x3_weight
// keeps them with the weight, so a step splits nothing).
//
// Replaces: vr_video_generator_tpu/ops/mlp_pallas.py `_kernel_resident`
// (row 8, the weights resident, where both fit in 10 MiB: at f32 D = 128
// and 384) and `_kernel` (row 9, hidden-blocked above: at f32 D = 768 and
// 1024), run at f32. Rounding points as there at f32: LN with f32 statistics
// and affine; fc1's f32 sum, + b1; the GELU in f32, every operation rounded
// (csrc/epilogue_f32.cuh); fc2's f32 sum, + b2; gamma * y, then x + that.
// The TPU's row 9 sums fc2 over 512-wide hidden blocks, and this chain sums
// 32-wide stages of 3xTF32 products in f32: the products agree with f32 ones
// to about 2^-21 of |a||b| a term, and the sums differ in their order. As at
// bf16 (csrc/mlp_hblocked.cu) the two rows differ only in how the TPU held
// the weights, so they are one chain here, each with its own entry point
// and widths.
//
// What bounds it on the H100: the two GEMMs are 16 M D^2 FLOPs, 46 GFLOP at
// vits (M = 8 * 2443 at 1080p/518, D = 384), 184 at vitb (D = 768) and 328
// at vitl-518 (D = 1024): 0.28, 1.12 and 1.99 ms at 3xTF32's 165 TFLOP/s
// (a third of the tensor cores' 495 TFLOP/s of TF32), against 0.4-1.0 GB of
// f32 traffic (x, out, the weights' hi and lo, a and h written and read:
// 0.12-0.3 ms at 3.35 TB/s): bound by operations. The hidden activations
// (M, 4D) f32 are scratch in device memory, as at bf16: 240 MB at
// vitb-518, 627 MB at vitl-728.
//
// vrvg_fc1_gelu_f32, the fc1 stage alone, exposes the epilogue for a check
// of its GELU through a selection fc1 (w1 rows that pick one input column
// each: every product but one is 0 * a, and the one left is hi(a) + lo(a)
// exactly, which chip_smoke.py's check feeds the eager GELU).

#include "tf32x3_gemm.cuh"

extern "C" int vrvg_layernorm_f32(const void* x, const void* w,
                                  const void* b, void* y, int m, int d,
                                  float eps, void* stream);

// The fc1 stage: a (M, D) f32 LayerNorm'd rows, w1s (4D, D) split, b1
// (4D,) f32 -> h (M, 4D) f32 = GELU(a w1^T + b1), the tanh GELU with
// approx != 0. D a multiple of 4.
extern "C" int vrvg_fc1_gelu_f32(const void* a, const void* w1s,
                                 const void* b1, void* h, int m, int d,
                                 int approx, void* stream) {
  const int hid = 4 * d;
  if (approx) {
    return tf32x3_gemm::gemm(
        (const float*)a, (const uint32_t*)w1s, m, hid, d, 0,
        tf32x3_gemm::BiasGelu<true>{hid, (float*)h, (const float*)b1},
        stream);
  }
  return tf32x3_gemm::gemm(
      (const float*)a, (const uint32_t*)w1s, m, hid, d, 0,
      tf32x3_gemm::BiasGelu<false>{hid, (float*)h, (const float*)b1}, stream);
}

namespace {

// LN -> fc1 + GELU -> fc2 + residual.
int chain(const void* x, const void* lnw, const void* lnb, const void* w1s,
          const void* b1, const void* w2s, const void* b2, const void* gamma,
          void* a, void* h, void* out, int m, int d, float eps, int approx,
          void* stream) {
  const int hid = 4 * d;
  int err = vrvg_layernorm_f32(x, lnw, lnb, a, m, d, eps, stream);
  if (err != 0) return err;
  err = vrvg_fc1_gelu_f32(a, w1s, b1, h, m, d, approx, stream);
  if (err != 0) return err;
  return tf32x3_gemm::gemm(
      (const float*)h, (const uint32_t*)w2s, m, d, hid, 0,
      tf32x3_gemm::LayerScaleResidual{d, (float*)out, (const float*)x,
                                      (const float*)b2, (const float*)gamma},
      stream);
}

}  // namespace

// Row 8 at f32: x (M, D) f32, LN affine (D,) f32, w1s (4D, D) split, b1
// (4D,), w2s (D, 4D) split, b2 (D,), gamma (D,) f32; scratch a (M, D) and h
// (M, 4D) f32 -> out (M, D) f32. D in {128, 384} (where the JAX package
// keeps the f32 weights resident). approx != 0: the tanh GELU.
extern "C" int vrvg_mlp_residual_f32(const void* x, const void* lnw,
                                     const void* lnb, const void* w1s,
                                     const void* b1, const void* w2s,
                                     const void* b2, const void* gamma,
                                     void* a, void* h, void* out, int m,
                                     int d, float eps, int approx,
                                     void* stream) {
  if (d != 128 && d != 384) return (int)cudaErrorInvalidValue;
  return chain(x, lnw, lnb, w1s, b1, w2s, b2, gamma, a, h, out, m, d, eps,
               approx, stream);
}

// Row 9 at f32: the same operands. D a multiple of 128 (the port takes it at
// D = 768 and 1024).
extern "C" int vrvg_mlp_residual_hblocked_f32(
    const void* x, const void* lnw, const void* lnb, const void* w1s,
    const void* b1, const void* w2s, const void* b2, const void* gamma,
    void* a, void* h, void* out, int m, int d, float eps, int approx,
    void* stream) {
  if (d <= 0 || d % 128 != 0) return (int)cudaErrorInvalidValue;
  return chain(x, lnw, lnb, w1s, b1, w2s, b2, gamma, a, h, out, m, d, eps,
               approx, stream);
}
