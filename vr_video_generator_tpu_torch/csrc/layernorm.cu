// Row LayerNorm with f32 statistics, for Hopper (sm_90a): bf16 rows in and
// out, the mean, variance and affine in f32, eps from the caller.
//
// Replaces: vr_video_generator_tpu/ops/layernorm.py `layernorm` (Pallas body
// `_ln_kernel`, row 1), whose arithmetic is `ln_rows_f32`: the mean, the
// mean of the squared deviations, (x - mean) * (1 / sqrt(var + eps)), then
// y * w + b with the f32 affine, cast to bf16. Each sum, product and
// quotient here is rounded on its own (no FMA), as gemm.cuh's
// layernorm_rows<D> computes it for rows 5, 8 and 10. Row 9's chain
// (csrc/mlp_hblocked.cu) runs its LN stage through this entry point.
//
// What bounds it on the H100: it reads D bf16 and writes D bf16 a row and
// does ~8 f32 operations an element, so it is bound by bytes: 30 MB at vits
// (19544 x 384), 9 us at 3.35 TB/s.
//
// Design: one warp per row, the row held in registers, 8 rows (warps) a
// block. Each width of the four encoders (128, 384, 768, 1024, 1536) is its
// own specialisation: a lane loads its share of the row as 16-byte vectors
// (8 bf16) where D is a multiple of 256, else 8-byte ones (4 bf16; D = 384
// is 24 bytes a lane), all issued before the first reduction; the two sums
// are butterfly shuffles; the row is read once and written once. Any other
// width, or an operand not 16-byte aligned, takes the generic kernel: the
// same arithmetic, one element a lane at a time, reading the row three times
// (from L1/L2 after the first).

#include "gemm.cuh"

namespace {

using namespace vrvg;

constexpr int ROWS = 8;  // rows, one a warp, per block

template <int VEC>
struct Vector;
template <>
struct Vector<8> {
  typedef uint4 T;
};
template <>
struct Vector<4> {
  typedef uint2 T;
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

template <int D>
__global__ void __launch_bounds__(ROWS * WARP)
    layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, bf16* __restrict__ y, int m,
                     float eps) {
  constexpr int VEC = D % 256 == 0 ? 8 : 4;  // bf16 a vector
  constexpr int NV = D / (WARP * VEC);       // vectors a lane
  static_assert(NV * WARP * VEC == D, "D must be a multiple of 128");
  typedef typename Vector<VEC>::T V;
  const int lane = threadIdx.x % WARP;
  const long long row = (long long)blockIdx.x * ROWS + threadIdx.x / WARP;
  if (row >= m) return;
  const V* src = reinterpret_cast<const V*>(x + row * D);
  V* dst = reinterpret_cast<V*>(y + row * D);

  float v[NV][VEC];
  V raw[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) raw[i] = __ldg(src + i * WARP + lane);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const bf16* e = reinterpret_cast<const bf16*>(&raw[i]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[i][j] = bf(e[j]);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) s = __fadd_rn(s, v[i][j]);
  const float mean = __fdiv_rn(warp_sum(s), (float)D);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      v[i][j] = __fsub_rn(v[i][j], mean);
      q = __fadd_rn(q, __fmul_rn(v[i][j], v[i][j]));
    }
  }
  const float var = __fdiv_rn(warp_sum(q), (float)D);
  const float rstd = __fdiv_rn(1.f, sqrtf(__fadd_rn(var, eps)));
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * WARP + lane) * VEC;
    float wv[VEC], bv[VEC];
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 w4 = __ldg(reinterpret_cast<const float4*>(w + c + j));
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(b + c + j));
      wv[j] = w4.x, wv[j + 1] = w4.y, wv[j + 2] = w4.z, wv[j + 3] = w4.w;
      bv[j] = b4.x, bv[j + 1] = b4.y, bv[j + 2] = b4.z, bv[j + 3] = b4.w;
    }
    V out;
    bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float t = __fmul_rn(v[i][j], rstd);
      o[j] = rbf(__fadd_rn(__fmul_rn(t, wv[j]), bv[j]));
    }
    dst[i * WARP + lane] = out;
  }
}

// Any D: the same arithmetic, one element a lane at a time.
__global__ void __launch_bounds__(ROWS * WARP)
    layernorm_kernel_any(const bf16* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ b, bf16* __restrict__ y,
                         int m, int d, float eps) {
  const int lane = threadIdx.x % WARP;
  const long long row = (long long)blockIdx.x * ROWS + threadIdx.x / WARP;
  if (row >= m) return;
  const bf16* src = x + row * d;
  bf16* dst = y + row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += WARP) s = __fadd_rn(s, bf(src[c]));
  const float mean = __fdiv_rn(warp_sum(s), (float)d);
  float q = 0.f;
  for (int c = lane; c < d; c += WARP) {
    const float t = __fsub_rn(bf(src[c]), mean);
    q = __fadd_rn(q, __fmul_rn(t, t));
  }
  const float var = __fdiv_rn(warp_sum(q), (float)d);
  const float rstd = __fdiv_rn(1.f, sqrtf(__fadd_rn(var, eps)));
  for (int c = lane; c < d; c += WARP) {
    const float t = __fmul_rn(__fsub_rn(bf(src[c]), mean), rstd);
    dst[c] = rbf(__fadd_rn(__fmul_rn(t, w[c]), b[c]));
  }
}

template <int D>
int run(const void* x, const void* w, const void* b, void* y, int m,
        float eps, cudaStream_t stream) {
  layernorm_kernel<D><<<(m + ROWS - 1) / ROWS, ROWS * WARP, 0, stream>>>(
      (const bf16*)x, (const float*)w, (const float*)b, (bf16*)y, m, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, D) bf16, w and b (D,) f32 -> y (M, D) bf16, on `stream`. Returns
// cudaGetLastError().
extern "C" int vrvg_layernorm(const void* x, const void* w, const void* b,
                              void* y, int m, int d, float eps,
                              void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = (((uintptr_t)x | (uintptr_t)y | (uintptr_t)w |
                         (uintptr_t)b) & 15u) == 0;
  if (aligned) {
    switch (d) {
      case 128: return run<128>(x, w, b, y, m, eps, s);
      case 384: return run<384>(x, w, b, y, m, eps, s);
      case 768: return run<768>(x, w, b, y, m, eps, s);
      case 1024: return run<1024>(x, w, b, y, m, eps, s);
      case 1536: return run<1536>(x, w, b, y, m, eps, s);
      default: break;
    }
  }
  layernorm_kernel_any<<<(m + ROWS - 1) / ROWS, ROWS * WARP, 0, s>>>(
      (const bf16*)x, (const float*)w, (const float*)b, (bf16*)y, m, d, eps);
  return (int)cudaGetLastError();
}
