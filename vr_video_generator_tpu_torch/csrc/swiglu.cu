// The SwiGLU half-block of the vitg (DINOv2-giant) blocks, for Hopper
// (sm_90a): out = x + gamma * (w3(silu(x1) * x2) + b3), [x1 | x2] =
// w12(LN2(x)) + b12, as a chain of three kernels on the caller's stream:
//
//   1. row 1's LayerNorm kernel (csrc/layernorm.cu): x -> h, (M, D) bf16;
//   2. gate: the TMA + wgmma GEMM core (csrc/wgmma_gemm.cuh) for h w12^T as
//      a gated product, f32 sums -> bf16, + b12 in bf16, then
//      silu(x1) * x2 -> bf16 g, (M, H);
//   3. down: the same core for g w3^T, f32 sums over all of H -> bf16 once,
//      then the core's LayerScaleResidual (+ b3, gamma * ., x + ., each
//      rounded to bf16) -> out, (M, D).
//
// Replaces: vr_video_generator_tpu/ops/mlp_pallas.py `_swiglu_kernel` (row
// 10, swiglu_residual_pallas), at its rounding points. x1 is the first half
// of w12's outputs (rows [0, H) of the upstream `mlp.w12.weight`), as
// jnp.split(t, 2) takes it. silu is rounded as XLA rounds jax.nn.silu on
// bf16: it evaluates logistic(x) as 1 / (1 + exp(-x)) with a bf16 rounding
// after the exp, the add and the divide, then rounds x * s, then the
// product with x2 (ops/mlp.silu_mul); expf and a correctly rounded divide,
// no fast math. The TPU kernel accumulates w3 in f32 over hidden chunks and
// casts once; the down product's f32 sum over all of H is the same rounding
// point.
//
// What bounds it on the H100: at 1080p/vitg (B = 8, M = 8 * 2443 rows, D =
// 1536, H = 4096) the two products are 737.7 GFLOP (0.75 ms at the 989
// TFLOP/s bf16 peak) against 60 MB of x in and 60 MB out: compute-bound.
//
// Design. The TPU kernel keeps the (rows, H) hidden activations in VMEM; for
// a 128-row wgmma tile at D = 1536 that does not fit an SM, so the chain
// writes h (60 MB) and g (160 MB) to device memory and reads each back once
// (~0.13 ms of traffic at 3.35 TB/s), as row 9's chain does. The gate's
// product tile is 128 rows by 256 columns of w12's outputs: x1's columns
// [n0, n0 + 128) and x2's [H + n0, H + n0 + 128), loaded as two 128-row TMA
// boxes of w12 in its upstream layout. In the accumulator a thread that
// holds x1's column c holds x2's column c too, so the epilogue pairs them
// without a shuffle and stores a 128-column tile of g (the core's gated
// mode). silu_mul is the light epilogue (an expf and a reciprocal a g value,
// half the values of row 9's GELU tile), so the three epilogue warps finish
// it all under the next tile's products, as long as its reciprocal takes no
// branch (see silu_mul). The earlier chain (a wmma gate and
// down kernel, 128 x 128 tiles, unpipelined loads) took 5.76 ms at vitg-518,
// 7.7x the bound (PERF.md).

#include <cuda_bf16.h>

#include "wgmma_gemm.cuh"

extern "C" int vrvg_layernorm(const void* x, const void* w, const void* b,
                              void* y, int m, int d, float eps, void* stream);

namespace {

using namespace vrvg;

using tma_gemm::load_bf16;

// silu(x1) * x2 at XLA's bf16 rounding points (see the header). a = bf16(1
// + exp(-x)) >= 1, and s = 1 / a is recip_ge1's correctly rounded quotient.
// recip_ge1 is exact below 2^64; past it (x1 <= -44.5; a = inf past x1 <
// -88.7) a is scaled by 2^-64 first and the quotient by 2^-64 after, both
// exact where the quotient is normal; where it is subnormal (x1 = -87.5,
// -88, -88.5) the second scaling rounds again, to the same bf16 s (checked
// on every bf16 x1 against the plain version, chip_smoke.py). A select and
// not a branch: the IEEE division's slow path, on a branch, kept ptxas from
// interleaving a thread's eight values and made the whole gate product a
// third slower on an H100 (PERF.md).
__device__ __forceinline__ bf16 silu_mul(bf16 x1, bf16 x2) {
  const float x = bf(x1);
  const bf16 e = rbf(expf(-x));
  const float a = bf(rbf(__fadd_rn(1.f, bf(e))));
  const float k = a < 0x1p64f ? 1.f : 0x1p-64f;
  const float s = __fmul_rn(recip_ge1(__fmul_rn(a, k)), k);
  return mul_bf(rbf(__fmul_rn(x, bf(rbf(s)))), x2);
}

// g = silu(bf16(h w12^T)[:, :H] + b12[:H]) * (bf16(h w12^T)[:, H:] + b12[H:]),
// all of it on the epilogue warps (the consumers finishing one of the two
// boxes measured slower on an H100, PERF.md).
struct SwigluGate {
  static constexpr int CONSUMER_BOXES = 0;
  static constexpr bool GATED = true;
  static constexpr bool SUM_BIAS = false;
  const bf16* bias;  // b12, (2H,)
  int hidden;
  template <int N>
  __device__ __forceinline__ void operator()(bf16 (&v)[N],
                                             const bf16 (&u)[N], int,
                                             int col) const {
    __align__(16) bf16 b1[N];
    __align__(16) bf16 b2[N];
    load_bf16(b1, bias + col);
    load_bf16(b2, bias + hidden + col);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      v[e] = silu_mul(add_bf(v[e], b1[e]), add_bf(u[e], b2[e]));
    }
  }
};

__global__ void silu_mul_kernel(const bf16* __restrict__ x1,
                                const bf16* __restrict__ x2,
                                bf16* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = silu_mul(x1[i], x2[i]);
}

}  // namespace

// x (M, D) bf16, LN affine (D,) f32, w12 (2H, D) and b12 (2H,), w3 (D, H),
// b3 (D,), gamma (D,) bf16; scratch h (M, D) and g (M, H) bf16 -> out (M, D)
// bf16. D a multiple of 64, H of 128 (the port takes D = 1536, H = 4096).
extern "C" int vrvg_swiglu_residual(const void* x, const void* lnw,
                                    const void* lnb, const void* w12,
                                    const void* b12, const void* w3,
                                    const void* b3, const void* gamma,
                                    void* h, void* g, void* out, int m, int d,
                                    int hidden, float eps, void* stream) {
  int err = vrvg_layernorm(x, lnw, lnb, h, m, d, eps, stream);
  if (err != 0) return err;
  err = tma_gemm::gemm(h, w12, g, m, hidden, d,
                       SwigluGate{(const bf16*)b12, hidden}, stream);
  if (err != 0) return err;
  return tma_gemm::gemm(g, w3, out, m, d, hidden,
                        tma_gemm::LayerScaleResidual{
                            (const bf16*)b3, (const bf16*)gamma,
                            (const bf16*)x, m, d},
                        stream);
}

// The gate epilogue's silu_mul alone, elementwise over n bf16 values: how
// chip_smoke.py holds it against the plain version on every bf16 x1.
extern "C" int vrvg_silu_mul(const void* x1, const void* x2, void* out,
                             int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  silu_mul_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)x1, (const bf16*)x2, (bf16*)out, n);
  return (int)cudaGetLastError();
}
