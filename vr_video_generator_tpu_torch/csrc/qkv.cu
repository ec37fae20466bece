// The two ends of the fused attention half-block, for Hopper (sm_90a):
//
//   ln_qkv:            x -> LN1 -> qkv GEMM -> bf16 -> + bias -> q * scale
//   proj_ls_residual:  o -> proj GEMM -> bf16 -> + bias -> gamma * . -> x + .
//
// Replaces: vr_video_generator_tpu/ops/qkv_pallas.py `_ln_qkv_kernel`
// (ln_qkv_pallas, row 5) and `_proj_kernel` (proj_ls_residual_pallas, row
// 6). Rounding points as there and as flax's nn.Dense: LN with f32
// statistics and the f32 affine, cast to bf16; the GEMM accumulates in f32
// and is cast to bf16 BEFORE the bf16 bias add; q becomes bf16(f32(q) *
// scale); gamma * y and x + that each round to bf16. Every product and sum
// of the epilogues is an explicit __fmul_rn / __fadd_rn, so nothing
// contracts into an FMA across those roundings.
//
// Layout. The TPU kernel writes per-head (B, H, N_pad, 64) tiles with zeroed
// pad rows, the contract of its attention kernel. The port's attention
// kernel (csrc/attention.cu) masks keys >= N itself and reads q, k and v as
// strided (B, N, H, 64) views, so ln_qkv writes the plain (B*N, 3D) product,
// i.e. (B, N, 3, H, 64): no pad, no transpose, no copy. proj reads the
// attention output (B, N, H, 64) as (B*N, D).
//
// What bounds them on the H100: at 1080p/vitl-518 (M = 8 * 2443 rows, D =
// 1024) ln_qkv is 123 GFLOP (0.124 ms at the 989 TFLOP/s bf16 peak) against
// ~166 MB of traffic (0.05 ms): compute-bound; at vits (D = 384) 17.3 GFLOP
// against ~61 MB, balanced (18 us either way). proj is 41 GFLOP at vitl-518
// (0.041 ms) against ~120 MB (0.036 ms); at vits 5.8 GFLOP against ~45 MB:
// memory-bound.
//
// ln_qkv's design: a chain of row 1's LayerNorm kernel (csrc/layernorm.cu),
// x -> a, (M, D) bf16 scratch, then the TMA + wgmma GEMM core
// (csrc/wgmma_gemm.cuh) for a w^T with QkvEpilogue on the bf16 sums. The LN
// is computed once a row (the earlier kernel, one block a 64 x 128 tile,
// recomputed it for every column tile: 24 times at D = 1024) at the cost of
// writing and reading a once (2 x 40 MB at vitl-518, ~0.024 ms). 3D is a
// multiple of the core's 256-column tile at D = 768 and 1024; at D = 128
// and 384 the last column tile is ragged (TMA zero-fills w's rows >= 3D,
// the store clips columns >= 3D, the epilogue is never asked for them).
//
// proj's design: the same core for o w^T, with the arithmetic of the
// LayerScaleResidual epilogue that the MLP halves' down products use (rows 9
// and 10): bf16 sums, + bias, gamma *, x +, each rounded to bf16, three of a
// tile's four boxes on the consumers and the fourth on the epilogue warps
// (ProjEpilogue). D = 384 leaves a ragged last column tile (256 + 128), as
// row 5's 3D does. (The earlier kernel, one unpipelined wmma block a 64 x
// 128 tile with all of its A rows in shared memory, took 0.575 ms at
// vitl-518 on an H100, 14x its bound and 2x its plain version.)

#include "wgmma_gemm.cuh"

extern "C" int vrvg_layernorm(const void* x, const void* w, const void* b,
                              void* y, int m, int d, float eps, void* stream);

namespace {

using namespace vrvg;

using tma_gemm::load_bf16;

// ln_qkv's epilogue: [q * scale | k | v] = bf16(a w^T) + bias, q's columns
// (< d) scaled in f32 and rounded back.
struct QkvEpilogue {
  static constexpr int CONSUMER_BOXES = 0;
  static constexpr bool GATED = false;
  static constexpr bool SUM_BIAS = false;
  const bf16* bias;  // (3D,)
  int d;
  float scale;
  template <int N>
  __device__ __forceinline__ void operator()(bf16 (&v)[N], int,
                                             int col) const {
    __align__(16) bf16 b[N];
    load_bf16(b, bias + col);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      bf16 t = add_bf(v[e], b[e]);
      if (col < d) t = rbf(__fmul_rn(bf(t), scale));
      v[e] = t;
    }
  }
};

// proj's epilogue: LayerScaleResidual's arithmetic, with the consumers
// finishing three of a 128 x 256 tile's four 64-column boxes from their
// registers. Its K = D (6 or 16 slices) leaves too little product time a
// tile to hide three epilogue warps' loads of x, bias and gamma, which rows 9
// and 10 hide under K = 4096. A row past M reads row M - 1 (its result is
// clipped by the store) so the consumers' unrolled loads issue together.
// On an H100 at 1080p, B = 8: 93 / 176 us a call (D = 384 / 1024) with the
// epilogue warps alone, 57 / 114 with two boxes, 48 / 107 with three.
struct ProjEpilogue : tma_gemm::LayerScaleResidual {
  static constexpr int CONSUMER_BOXES = 3;
  template <int N>
  __device__ __forceinline__ void operator()(bf16 (&v)[N], int row,
                                             int col) const {
    apply(v, row < m ? row : m - 1, col);
  }
};

}  // namespace

// x (M, D) bf16, LN affine (D,) f32, w (3D, D) bf16, b (3D,) bf16; scratch
// a (M, D) bf16 -> out (M, 3D) bf16 = (B, N, 3, H, 64). D a multiple of 64.
extern "C" int vrvg_ln_qkv(const void* x, const void* lnw, const void* lnb,
                           const void* w, const void* b, void* a, void* out,
                           int m, int d, float scale, float eps,
                           void* stream) {
  int err = vrvg_layernorm(x, lnw, lnb, a, m, d, eps, stream);
  if (err != 0) return err;
  return tma_gemm::gemm(a, w, out, m, 3 * d, d,
                        QkvEpilogue{(const bf16*)b, d, scale}, stream);
}

// o (M, D) bf16 (the attention output), x (M, D) bf16 residual, w (D, D),
// b (D,), gamma (D,) bf16 -> out (M, D) bf16 = x + gamma * (o w^T + b). D a
// multiple of 64.
extern "C" int vrvg_proj_ls_residual(const void* o, const void* x,
                                     const void* w, const void* b,
                                     const void* gamma, void* out, int m,
                                     int d, void* stream) {
  return tma_gemm::gemm(o, w, out, m, d, d,
                        ProjEpilogue{{(const bf16*)b, (const bf16*)gamma,
                                      (const bf16*)x, m, d}},
                        stream);
}
