// The hidden-blocked MLP half-block of vitl's blocks (D = 1024, hidden
// 4096), for Hopper (sm_90a): out = x + gamma * (fc2(GELU(fc1(LN2(x))))),
// as a chain of three kernels on the caller's stream.
//
// Replaces: vr_video_generator_tpu/ops/mlp_pallas.py `_kernel` (row 9: the
// hidden-blocked grid that mlp_residual_pallas takes when the 16 MB of
// weights do not fit in VMEM). Rounding points as there and as row 8
// (csrc/mlp.cu): LN with f32 statistics and the f32 affine, cast to bf16;
// fc1 accumulates in f32, is cast to bf16, then + b1 in bf16; the A&S GELU
// in f32, every operation rounded (gemm.cuh's gelu_as), cast to bf16; fc2
// accumulates in f32 over all 4096 hidden columns, is cast to bf16 once;
// + b2, gamma * . and x + . each round to bf16.
//
// What bounds it on the H100: the two GEMMs are 2 * 2 * M * 1024 * 4096
// FLOPs, 328 GFLOP at vitl-518 (M = 8 * 2443), 0.33 ms at the 989 TFLOP/s
// bf16 peak; it is compute-bound.
//
// Design: the TPU kernel keeps the (rows x 1024) f32 fc2 sum on the chip
// while it walks the hidden dimension; for a 128-row wgmma tile that is
// 512 KB, more than an SM holds. The hidden activations are rounded to bf16
// before fc2 in the JAX kernel too, so writing them to device memory moves
// no rounding point, only the order of fc2's f32 sum: 160 MB each way at
// vitl-518, ~0.1 ms. So the chain is
//   1. row 1's LayerNorm kernel (csrc/layernorm.cu): x -> a, (M, 1024) bf16;
//   2. the persistent TMA + wgmma GEMM core (csrc/wgmma_gemm.cuh) for
//      a W1^T, its epilogue warpgroup adding b1 and taking the GELU on the
//      bf16 sums: h, (M, 4096) bf16;
//   3. the same core for h W2^T, its epilogue (the core's
//      LayerScaleResidual, which row 10 shares) + b2, gamma * ., x + .:
//      out, (M, 1024) bf16.
// a and h are scratch the caller allocates. The GELU (one reciprocal, one
// expf and ~15 other rounded f32 operations an element, 80M elements at
// vitl-518) is what fc1 pays over fc2: half of it runs on the epilogue warps
// under the next tile's products, half on the consumers.

#include <cuda_bf16.h>

#include "wgmma_gemm.cuh"

extern "C" int vrvg_layernorm(const void* x, const void* w, const void* b,
                              void* y, int m, int d, float eps, void* stream);

namespace {

using namespace vrvg;

using tma_gemm::load_bf16;

// h = bf16(gelu(bf16(a w1^T) + b1)). The GELU is the costly epilogue: the
// consumers finish two of each tile's four 64-column boxes themselves (on
// an H100, fc1 at M = 19544 took 368 us so, 399 with one box, 398 with
// none, 386 with all four on the consumers).
struct Fc1Gelu {
  static constexpr int CONSUMER_BOXES = 2;
  static constexpr bool GATED = false;
  const bf16* bias;  // b1
  template <int N>
  __device__ __forceinline__ void operator()(bf16 (&v)[N], int,
                                             int col) const {
    __align__(16) bf16 b[N];
    load_bf16(b, bias + col);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      v[e] = rbf(gelu_as(bf(add_bf(v[e], b[e]))));
    }
  }
};

}  // namespace

// Row 9: x (M, D) bf16, LN affine (D,) f32, w1 (4D, D), b1 (4D,), w2 (D, 4D),
// b2 (D,), gamma (D,) bf16; scratch a (M, D) and h (M, 4D) bf16 -> out (M,
// D) bf16. D a multiple of 256 (the port takes it at D = 1024).
extern "C" int vrvg_mlp_residual_hblocked(
    const void* x, const void* lnw, const void* lnb, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* gamma,
    void* a, void* h, void* out, int m, int d, float eps, void* stream) {
  if (d % tma_gemm::BN != 0) return (int)cudaErrorInvalidValue;
  const int hid = 4 * d;
  int err = vrvg_layernorm(x, lnw, lnb, a, m, d, eps, stream);
  if (err != 0) return err;
  err = tma_gemm::gemm(a, w1, h, m, hid, d, Fc1Gelu{(const bf16*)b1},
                       stream);
  if (err != 0) return err;
  return tma_gemm::gemm(h, w2, out, m, d, hid,
                        tma_gemm::LayerScaleResidual{
                            (const bf16*)b2, (const bf16*)gamma,
                            (const bf16*)x, m, d},
                        stream);
}
