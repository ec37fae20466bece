// The MLP half-block of the DINOv2 blocks with a GELU MLP at f32
// (--compute_dtype float32), for Hopper (sm_90a): out = x + gamma *
// (fc2(GELU(fc1(LN2(x))))), hidden 4D, as a chain of three launches on the
// caller's stream:
//
//   1. row 1's f32 LayerNorm (csrc/layernorm.cu, vrvg_layernorm_f32):
//      x -> a, (M, D) f32;
//   2. fc1 on the f32 GEMM core (csrc/sgemm.cuh, 128 x 128 tiles), its
//      epilogue (sgemm::BiasGelu) adding b1 to the f32 sum and taking the
//      GELU (the A&S form of csrc/gelu_as.cuh, or with `approx` the tanh
//      form) on it: h, (M, 4D) f32;
//   3. fc2 on the same core, its epilogue (sgemm::LayerScaleResidual, row
//      6's at f32) + b2, gamma * ., x + .: out, (M, D) f32.
//
// Replaces: vr_video_generator_tpu/ops/mlp_pallas.py `_kernel_resident`
// (row 8, the weights resident, where both fit in 10 MiB: at f32 D = 128
// and 384) and `_kernel` (row 9, hidden-blocked above: at f32 D = 768 and
// 1024), run at f32. Rounding points as there at f32: LN with f32 statistics
// and affine; fc1's f32 sum, + b1; the GELU in f32, every operation rounded;
// fc2's f32 sum, + b2; gamma * y, then x + that. The TPU's row 9 sums fc2
// over 512-wide hidden blocks, and this chain over all of K at once: only
// the order of the f32 sums differs. As at bf16 (csrc/mlp_hblocked.cu) the
// two rows differ only in how the TPU held the weights, so they are one
// chain here, each with its own entry point and widths.
//
// What bounds it on the H100: the two GEMMs are 16 M D^2 FLOPs, 46 GFLOP at
// vits (M = 8 * 2443 at 1080p/518, D = 384), 184 at vitb (D = 768) and 328
// at vitl-518 (D = 1024): 0.69, 2.75 and 4.9 ms at the card's 67 TFLOP/s
// f32 rate outside the tensor cores, against 0.4-1.0 GB of f32 traffic
// (x, out, the weights, a and h written and read: 0.12-0.3 ms at 3.35
// TB/s): bound by operations, since wgmma takes no f32 operands and TF32 is
// not f32 (csrc/sgemm.cuh's header). The hidden activations (M, 4D) f32 are
// scratch in device memory, as at bf16: 240 MB at vitb-518, 627 MB at
// vitl-728.
//
// vrvg_fc1_gelu_f32, the fc1 stage alone, exposes the epilogue for a check
// of its GELU bit for bit through a selection fc1 (w1 rows that pick one
// input column each: every product but one is 0 * a, the sum exact) and for
// the CPU emulation of the chain (tests/test_torch_f32_emulation.py).

#include "sgemm.cuh"

extern "C" int vrvg_layernorm_f32(const void* x, const void* w,
                                  const void* b, void* y, int m, int d,
                                  float eps, void* stream);

// The fc1 stage: a (M, D) f32 LayerNorm'd rows, w1 (4D, D), b1 (4D,) f32 ->
// h (M, 4D) f32 = GELU(a w1^T + b1), the tanh GELU with approx != 0. D a
// multiple of 4.
extern "C" int vrvg_fc1_gelu_f32(const void* a, const void* w1,
                                 const void* b1, void* h, int m, int d,
                                 int approx, void* stream) {
  const int hid = 4 * d;
  const sgemm::DenseRows A{(const float*)a, d, m, d};
  const sgemm::DenseRows W{(const float*)w1, d, hid, d};
  if (approx) {
    return sgemm::gemm<sgemm::Square>(
        A, W, m, hid, d, sgemm::BiasGelu<true>{(float*)h, (const float*)b1,
                                               hid},
        stream);
  }
  return sgemm::gemm<sgemm::Square>(
      A, W, m, hid, d,
      sgemm::BiasGelu<false>{(float*)h, (const float*)b1, hid}, stream);
}

namespace {

// LN -> fc1 + GELU -> fc2 + residual.
int chain(const void* x, const void* lnw, const void* lnb, const void* w1,
          const void* b1, const void* w2, const void* b2, const void* gamma,
          void* a, void* h, void* out, int m, int d, float eps, int approx,
          void* stream) {
  const int hid = 4 * d;
  int err = vrvg_layernorm_f32(x, lnw, lnb, a, m, d, eps, stream);
  if (err != 0) return err;
  err = vrvg_fc1_gelu_f32(a, w1, b1, h, m, d, approx, stream);
  if (err != 0) return err;
  return sgemm::gemm<sgemm::Square>(
      sgemm::DenseRows{(const float*)h, hid, m, hid},
      sgemm::DenseRows{(const float*)w2, hid, d, hid}, m, d, hid,
      sgemm::LayerScaleResidual{(float*)out, (const float*)x,
                                (const float*)b2, (const float*)gamma, d},
      stream);
}

}  // namespace

// Row 8 at f32: x (M, D) f32, LN affine (D,) f32, w1 (4D, D), b1 (4D,), w2
// (D, 4D), b2 (D,), gamma (D,) f32; scratch a (M, D) and h (M, 4D) f32 ->
// out (M, D) f32. D in {128, 384} (where the JAX package keeps the f32
// weights resident). approx != 0: the tanh GELU.
extern "C" int vrvg_mlp_residual_f32(const void* x, const void* lnw,
                                     const void* lnb, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, const void* gamma,
                                     void* a, void* h, void* out, int m,
                                     int d, float eps, int approx,
                                     void* stream) {
  if (d != 128 && d != 384) return (int)cudaErrorInvalidValue;
  return chain(x, lnw, lnb, w1, b1, w2, b2, gamma, a, h, out, m, d, eps,
               approx, stream);
}

// Row 9 at f32: the same operands. D a multiple of 128 (the port takes it at
// D = 768 and 1024: fc2's N = D in whole 128-column tiles).
extern "C" int vrvg_mlp_residual_hblocked_f32(
    const void* x, const void* lnw, const void* lnb, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* gamma,
    void* a, void* h, void* out, int m, int d, float eps, int approx,
    void* stream) {
  if (d <= 0 || d % sgemm::Square::BN != 0) return (int)cudaErrorInvalidValue;
  return chain(x, lnw, lnb, w1, b1, w2, b2, gamma, a, h, out, m, d, eps,
               approx, stream);
}
