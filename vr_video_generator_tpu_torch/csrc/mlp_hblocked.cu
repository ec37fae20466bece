// The MLP half-block of the DINOv2 blocks with a GELU MLP (vits, vitb: row
// 8; vitl: row 9), for Hopper (sm_90a): out = x + gamma *
// (fc2(GELU(fc1(LN2(x))))), hidden H (4D at the published encoders; any
// int(D * mlp_ratio) of a custom ModelConfig, zero-padded to a multiple of
// 64 by the wrapper), as a chain of three kernels on the caller's stream.
//
// Replaces: vr_video_generator_tpu/ops/mlp_pallas.py `_kernel_resident`
// (row 8: the weights resident in VMEM, which mlp_residual_pallas takes
// where both fit in 10 MiB and H is a multiple of 512: D = 128, 384, 512,
// 768) and `_kernel` (row 9: the hidden-blocked grid otherwise: vitl's D =
// 1024, or H = 2080 at D = 640 and mlp_ratio 3.25), at any D % 128 == 0.
// Both compute `mlp_residual_ref`, at its rounding points: LN with f32
// statistics and the f32 affine, cast to bf16; fc1 accumulates in f32, is
// cast to bf16, then + b1 in bf16; the A&S GELU in f32, every operation
// rounded (gemm.cuh's gelu_as), cast to bf16; fc2 accumulates in f32 over
// the whole hidden width, is cast to bf16 once; + b2, gamma * . and x + .
// each round to bf16. They differ only in how the TPU held the weights, so
// on the GPU they are one chain with a tile shape per width.
//
// What bounds it on the H100: the two GEMMs are 2 * 2 * M * D * 4D FLOPs:
// 46 GFLOP at vits (M = 8 * 2443 at 1080p/518, D = 384), 184 at vitb (D =
// 768), 328 at vitl-518 (D = 1024); 0.047, 0.186 and 0.33 ms at the 989
// TFLOP/s bf16 peak, against ~30-80 MB of x, out and weights (10-25 us at
// 3.35 TB/s): compute-bound.
//
// Design: the TPU kernel keeps the (rows x D) f32 fc2 sum on the chip while
// it walks the hidden dimension; for a 128-row wgmma tile that is 128 x D x
// 4 bytes (192 registers a consumer thread at D = 384, 512 KB at D = 1024),
// more than an SM holds. The hidden activations are rounded to bf16 before
// fc2 in the JAX kernel too, so writing them to device memory moves no
// rounding point, only the order of fc2's f32 sum: 60 MB each way at vits,
// 120 at vitb, 160 at vitl-518 (0.04-0.1 ms). So the chain is
//   1. row 1's LayerNorm kernel (csrc/layernorm.cu): x -> a, (M, D) bf16;
//   2. the persistent TMA + wgmma GEMM core (csrc/wgmma_gemm.cuh) for
//      a W1^T on 128 x 256 tiles, its epilogue adding b1 and taking the
//      GELU on the bf16 sums: h, (M, H) bf16;
//   3. the same core for h W2^T, its epilogue (the core's
//      LayerScaleResidual, which rows 6 and 10 share) + b2, gamma * ., x +
//      .: out, (M, D) bf16, on tiles as wide as D allows without a ragged
//      column tile: 128 x 256 at D = 768 and 1024, 128 x 192 at D = 384
//      (0.092 ms on an H100 at M = 19544, against 0.120 on 128 x 256 tiles
//      with a ragged second one), 128 x 128 at D = 128.
// a and h are scratch the caller allocates. The GELU (one reciprocal, one
// expf and ~15 other rounded f32 operations an element, 4D of them a row)
// is what fc1 pays over fc2: part of it runs on the epilogue warps under
// the next tile's products, part on the consumers. At K = D = 384 a fc1
// tile has only six K slices, so the GELU, not the products, can set its
// time.
//
// --gelu tanh (ModelConfig.gelu_approx): the TPU kernels take `approx` and
// apply jax.nn.gelu(t, approximate=True) to the bf16 t = bf16(a w1^T) + b1
// (mlp_pallas.py:50-55), which rounds every operation to bf16: x^3 as (x x)
// x, 0.044715 and sqrt(2/pi) as bf16 constants, + x, * sqrt(2/pi), tanh, 1
// + ., 0.5 * ., x * . (ops/gelu.gelu_tanh). The chain's fc1 epilogue has a
// variant (Fc1Gelu's TANH) that does the same on the card: each step an
// f32 operation on bf16 values, __fmul_rn/__fadd_rn so that nothing
// contracts to an FMA, IEEE tanhf (not tanh.approx.f32), each result
// rounded to bf16. It is lighter than the A&S GELU (one tanhf and nine
// rounded operations against an expf, a reciprocal and ~15), so the tanh
// chains keep the exact ones' share of boxes on the consumers.

#include <cuda_bf16.h>

#include "wgmma_gemm.cuh"

extern "C" int vrvg_layernorm(const void* x, const void* w, const void* b,
                              void* y, int m, int d, float eps, void* stream);

namespace {

using namespace vrvg;

using tma_gemm::load_bf16;
using tma_gemm::Tile;
using tma_gemm::Wide;

// h = bf16(gelu(bf16(a w1^T) + b1)). The GELU is the costly epilogue: the
// consumers finish CB of each tile's four 64-column boxes themselves, the
// epilogue warps the rest under the next tile's products. The share that
// measured fastest falls with K = D, the products a tile has to hide the
// GELU under (on an H100 at M = 19544: at D = 1024, 368 us with two boxes,
// 399 with one, 398 with none, 386 with four; at D = 768 and 384, 0.280
// and 0.109 ms with three, 0.301 and 0.114 with two; at D = 128, 0.044
// with one, 0.050 with two, 0.063 with three).
// jax.nn.gelu(x, approximate=True) on a bf16 x at XLA's bf16 rounding
// points (see the header): every product and sum an f32 operation on bf16
// values, rounded to bf16. C0 and C1 are 0.044715 and sqrt(2/pi) rounded
// to bf16 (0.044677734375 and 0.796875).
__device__ __forceinline__ bf16 gelu_tanh(bf16 xb) {
  constexpr float C0 = 0.044677734375f, C1 = 0.796875f;
  const float x = bf(xb);
  const float x2 = bf(rbf(__fmul_rn(x, x)));
  const float x3 = bf(rbf(__fmul_rn(x2, x)));
  const float p = bf(rbf(__fmul_rn(x3, C0)));
  const float s = bf(rbf(__fadd_rn(x, p)));
  const float u = bf(rbf(__fmul_rn(s, C1)));
  const float t = bf(rbf(tanhf(u)));
  const float c = bf(rbf(__fmul_rn(0.5f, bf(rbf(__fadd_rn(1.f, t))))));
  return rbf(__fmul_rn(x, c));
}

template <int CB, bool TANH = false>
struct Fc1Gelu {
  static constexpr int CONSUMER_BOXES = CB;
  static constexpr bool GATED = false;
  static constexpr bool F32_STEP = false;
  const bf16* bias;  // b1
  template <int N>
  __device__ __forceinline__ void operator()(bf16 (&v)[N], int,
                                             int col) const {
    __align__(16) bf16 b[N];
    load_bf16(b, bias + col);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      if constexpr (TANH) {
        v[e] = gelu_tanh(add_bf(v[e], b[e]));
      } else {
        v[e] = rbf(gelu_as(bf(add_bf(v[e], b[e]))));
      }
    }
  }
};

__global__ void gelu_tanh_kernel(const bf16* __restrict__ x,
                                 bf16* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = gelu_tanh(x[i]);
}

// LN -> fc1 + GELU (CB consumer boxes; the tanh GELU with TANH) -> fc2 +
// residual, fc2 on Fc2Shape's tiles; hid the hidden width.
template <int CB, class Fc2Shape, bool TANH>
int chain_at(const void* x, const void* lnw, const void* lnb, const void* w1,
             const void* b1, const void* w2, const void* b2,
             const void* gamma, void* a, void* h, void* out, int m, int d,
             int hid, float eps, void* stream) {
  int err = vrvg_layernorm(x, lnw, lnb, a, m, d, eps, stream);
  if (err != 0) return err;
  err = tma_gemm::gemm(a, w1, h, m, hid, d,
                       Fc1Gelu<CB, TANH>{(const bf16*)b1}, stream);
  if (err != 0) return err;
  return tma_gemm::gemm<Fc2Shape>(
      h, w2, out, m, d, hid,
      tma_gemm::LayerScaleResidual{(const bf16*)b2, (const bf16*)gamma,
                                   (const bf16*)x, m, d},
      stream);
}

template <int CB, class Fc2Shape>
int chain(const void* x, const void* lnw, const void* lnb, const void* w1,
          const void* b1, const void* w2, const void* b2, const void* gamma,
          void* a, void* h, void* out, int m, int d, int hid, float eps,
          int approx, void* stream) {
  return approx ? chain_at<CB, Fc2Shape, true>(x, lnw, lnb, w1, b1, w2, b2,
                                               gamma, a, h, out, m, d, hid,
                                               eps, stream)
                : chain_at<CB, Fc2Shape, false>(x, lnw, lnb, w1, b1, w2, b2,
                                                gamma, a, h, out, m, d, hid,
                                                eps, stream);
}

// The chain at any D that is a multiple of 128, the JAX kernels' widths
// (mlp_pallas.py asserts D % 128 == 0), and any hidden width a multiple of
// 64 (the core's K slice: the wrapper zero-pads fc1's rows, b1 and fc2's
// columns to one, which leaves every sum as it was). fc2 runs on the widest
// tile that divides D, so no column tile is ragged: 128 x 256 where 256
// divides D (vitb, vitl, D = 512), 128 x 192 where 192 does (vits, D =
// 1152), 128 x 128 otherwise (D = 128, 640). fc1's consumers finish one of
// its four GELU boxes at D = 128, three below D = 1024 and two from there on
// (the shares that measured fastest at D = 128, 384 and 768, and 1024).
template <int CB>
int at_width(const void* x, const void* lnw, const void* lnb, const void* w1,
             const void* b1, const void* w2, const void* b2,
             const void* gamma, void* a, void* h, void* out, int m, int d,
             int hid, float eps, int approx, void* stream) {
  if (d % Wide::BN == 0) {
    return chain<CB, Wide>(x, lnw, lnb, w1, b1, w2, b2, gamma, a, h, out, m,
                           d, hid, eps, approx, stream);
  }
  if (d % 192 == 0) {
    return chain<CB, Tile<128, 192>>(x, lnw, lnb, w1, b1, w2, b2, gamma, a,
                                     h, out, m, d, hid, eps, approx, stream);
  }
  return chain<CB, Tile<128, 128>>(x, lnw, lnb, w1, b1, w2, b2, gamma, a, h,
                                   out, m, d, hid, eps, approx, stream);
}

int any_width(const void* x, const void* lnw, const void* lnb, const void* w1,
              const void* b1, const void* w2, const void* b2,
              const void* gamma, void* a, void* h, void* out, int m, int d,
              int hid, float eps, int approx, void* stream) {
  if (d <= 0 || d % 128 != 0 || hid <= 0 || hid % tma_gemm::BK != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (d == 128) {
    return at_width<1>(x, lnw, lnb, w1, b1, w2, b2, gamma, a, h, out, m, d,
                       hid, eps, approx, stream);
  }
  if (d < 1024) {
    return at_width<3>(x, lnw, lnb, w1, b1, w2, b2, gamma, a, h, out, m, d,
                       hid, eps, approx, stream);
  }
  return at_width<2>(x, lnw, lnb, w1, b1, w2, b2, gamma, a, h, out, m, d,
                     hid, eps, approx, stream);
}

}  // namespace

// Row 8: x (M, D) bf16, LN affine (D,) f32, w1 (H, D), b1 (H,), w2 (D, H),
// b2 (D,), gamma (D,) bf16; scratch a (M, D) and h (M, H) bf16 -> out (M,
// D) bf16. D a multiple of 128, H of 64. approx != 0: the tanh GELU.
extern "C" int vrvg_mlp_residual(const void* x, const void* lnw,
                                 const void* lnb, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, const void* gamma, void* a,
                                 void* h, void* out, int m, int d, int hid,
                                 float eps, int approx, void* stream) {
  return any_width(x, lnw, lnb, w1, b1, w2, b2, gamma, a, h, out, m, d, hid,
                   eps, approx, stream);
}

// Row 9: the same operands and widths; the wrapper takes each width for the
// row the JAX rule gives it (ops/mlp.resident).
extern "C" int vrvg_mlp_residual_hblocked(
    const void* x, const void* lnw, const void* lnb, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* gamma,
    void* a, void* h, void* out, int m, int d, int hid, float eps, int approx,
    void* stream) {
  return any_width(x, lnw, lnb, w1, b1, w2, b2, gamma, a, h, out, m, d, hid,
                   eps, approx, stream);
}

// The tanh GELU of the fc1 epilogue, elementwise: x (n,) bf16 -> out (n,)
// bf16, for the check of its arithmetic on every bf16 input.
extern "C" int vrvg_gelu_tanh(const void* x, void* out, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  gelu_tanh_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (bf16*)out, n);
  return (int)cudaGetLastError();
}
