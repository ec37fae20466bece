// The two ends of the fused attention half-block, for Hopper (sm_90a):
//
//   ln_qkv:            x -> LN1 -> qkv GEMM -> bf16 -> + bias -> q * scale
//   proj_ls_residual:  o -> proj GEMM -> bf16 -> + bias -> gamma * . -> x + .
//
// Replaces: vr_video_generator_tpu/ops/qkv_pallas.py `_ln_qkv_kernel`
// (ln_qkv_pallas) and `_proj_kernel` (proj_ls_residual_pallas). Rounding
// points as there and as flax's nn.Dense: LN with f32 statistics and the
// f32 affine, cast to bf16; the GEMM accumulates in f32 and is cast to bf16
// BEFORE the bf16 bias add; q becomes bf16(f32(q) * scale); gamma * y and
// x + that each round to bf16. Every product and sum of the epilogue is an
// explicit __fmul_rn / __fadd_rn, so nothing contracts into an FMA across
// those roundings.
//
// Layout. The TPU kernel writes per-head (B, H, N_pad, 64) tiles with zeroed
// pad rows, the contract of its attention kernel. The port's attention
// kernel (csrc/attention.cu) masks keys >= N itself and reads q, k and v as
// strided (B, N, H, 64) views, so ln_qkv writes the plain (B*N, 3D) product,
// i.e. (B, N, 3, H, 64): no pad, no transpose, no copy. proj reads the
// attention output (B, N, H, 64) as (B*N, D).
//
// What bounds it on the H100: at 1080p/vits (M = 8 * 2443 rows, D = 384)
// ln_qkv is 17.3 GFLOP against ~61 MB of device traffic (18 us at 3.35 TB/s,
// 17.5 us at the 989 TFLOP/s bf16 peak): balanced. proj is 5.8 GFLOP against
// ~45 MB: memory-bound. The design keeps the LN output in shared memory (it
// never reaches device memory) and fuses bias, scale, LayerScale and the
// residual into the GEMM's epilogue, so each kernel reads its activations
// once and writes its result once.
//
// Design: one block of 8 warps per (64-row, 128-column) output tile. The
// block's 64 A rows (LN'd for ln_qkv) stay in shared memory for the whole K;
// weight tiles of 128 x 64 stream through shared memory; each warp owns a
// 32 x 32 sub-tile (2 x 2 wmma fragments). Simple first: no cp.async
// pipelining, wmma instead of wgmma/TMA, and ln_qkv recomputes the LN of its
// rows once per column tile (9 times at D = 384).

#include "gemm.cuh"

namespace {

using namespace vrvg;

constexpr int BM = 64, BN = 128, BK = 64;
constexpr int THREADS = 256;
constexpr int LDB = BK + 16;
constexpr int LDC = BN + 8;

// The A rows, or the f32 output staging that reuses their space.
template <int D>
__host__ __device__ constexpr size_t a_bytes() {
  constexpr size_t rows = (size_t)BM * (D + 16) * 2;
  constexpr size_t staged = (size_t)BM * LDC * 4;
  return align128(rows > staged ? rows : staged);
}

template <int D>
constexpr size_t smem_bytes() {
  return a_bytes<D>() + (size_t)BN * LDB * 2;
}

enum Mode { LN_QKV = 0, PROJ = 1 };

// MODE LN_QKV: out (M, 3D) = [q*scale | k | v] of LN(a) @ w^T + bias.
// MODE PROJ:   out (M, D)  = resid + gamma * (a @ w^T + bias).
template <int D, int MODE>
__global__ void __launch_bounds__(THREADS)
dense_rows_kernel(const bf16* __restrict__ a, const float* __restrict__ lnw,
                  const float* __restrict__ lnb, const bf16* __restrict__ w,
                  const bf16* __restrict__ bias,
                  const bf16* __restrict__ resid,
                  const bf16* __restrict__ gamma, bf16* __restrict__ out,
                  int m, float scale, float eps) {
  constexpr int N = MODE == LN_QKV ? 3 * D : D;
  constexpr int LDA = D + 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);  // aliases As after the K loop
  bf16* Bs = reinterpret_cast<bf16*>(smem + a_bytes<D>());

  const int tid = threadIdx.x;
  const int warp = tid / WARP;
  const int wm = warp / 4, wn = warp % 4;
  const long long row0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int valid = (int)min((long long)BM, (long long)m - row0);

  if constexpr (MODE == LN_QKV) {
    layernorm_rows<D>(As, LDA, a + row0 * D, BM, valid, lnw, lnb, eps);
  } else {
    load_rows(As, LDA, a + row0 * D, D, BM, D, valid, tid, THREADS);
  }

  FragC acc[2][2];
  zero(acc);
  for (int k0 = 0; k0 < D; k0 += BK) {
    __syncthreads();  // As ready; every warp done with the previous Bs
    load_rows(Bs, LDB, w + (long long)n0 * D + k0, D, BN, BK, BN, tid,
              THREADS);
    __syncthreads();
    mma_block<2, 2, BK>(acc, As + wm * 32 * LDA + k0, LDA,
                        Bs + wn * 32 * LDB, LDB);
  }
  __syncthreads();  // all warps done reading As before Cs overwrites it
  store(Cs + wm * 32 * LDC + wn * 32, LDC, acc);
  __syncthreads();

  for (int i = tid; i < BM * (BN / 8); i += THREADS) {
    const int r = i / (BN / 8);
    const int c = (i % (BN / 8)) * 8;
    if (r >= valid) continue;
    const int n = n0 + c;
    const long long row = row0 + r;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      bf16 t = add_bf(rbf(Cs[r * LDC + c + e]), bias[n + e]);
      if constexpr (MODE == LN_QKV) {
        if (n < D) t = rbf(__fmul_rn(bf(t), scale));
      } else {
        t = add_bf(resid[row * D + n + e], mul_bf(gamma[n + e], t));
      }
      v[e] = t;
    }
    *reinterpret_cast<uint4*>(out + row * N + n) =
        *reinterpret_cast<const uint4*>(v);
  }
}

template <int D, int MODE>
int run(const void* a, const void* lnw, const void* lnb, const void* w,
        const void* bias, const void* resid, const void* gamma, void* out,
        int m, float scale, float eps, void* stream) {
  constexpr int N = MODE == LN_QKV ? 3 * D : D;
  dim3 grid((m + BM - 1) / BM, N / BN);
  return launch(dense_rows_kernel<D, MODE>, grid, THREADS, smem_bytes<D>(),
                stream, (const bf16*)a, (const float*)lnw, (const float*)lnb,
                (const bf16*)w, (const bf16*)bias, (const bf16*)resid,
                (const bf16*)gamma, (bf16*)out, m, scale, eps);
}

template <int MODE>
int dispatch(int d, const void* a, const void* lnw, const void* lnb,
             const void* w, const void* bias, const void* resid,
             const void* gamma, void* out, int m, float scale, float eps,
             void* stream) {
  switch (d) {
    case 128: return run<128, MODE>(a, lnw, lnb, w, bias, resid, gamma, out, m, scale, eps, stream);
    case 384: return run<384, MODE>(a, lnw, lnb, w, bias, resid, gamma, out, m, scale, eps, stream);
    case 768: return run<768, MODE>(a, lnw, lnb, w, bias, resid, gamma, out, m, scale, eps, stream);
    case 1024: return run<1024, MODE>(a, lnw, lnb, w, bias, resid, gamma, out, m, scale, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, D) bf16, LN affine (D,) f32, w (3D, D) bf16, b (3D,) bf16 ->
// out (M, 3D) bf16 = (B, N, 3, H, 64). D in {128, 384, 768, 1024}.
extern "C" int vrvg_ln_qkv(const void* x, const void* lnw, const void* lnb,
                           const void* w, const void* b, void* out, int m,
                           int d, float scale, float eps, void* stream) {
  return dispatch<LN_QKV>(d, x, lnw, lnb, w, b, nullptr, nullptr, out, m,
                          scale, eps, stream);
}

// o (M, D) bf16 (the attention output), x (M, D) bf16 residual, w (D, D),
// b (D,), gamma (D,) bf16 -> out (M, D) bf16 = x + gamma * (o w^T + b).
extern "C" int vrvg_proj_ls_residual(const void* o, const void* x,
                                     const void* w, const void* b,
                                     const void* gamma, void* out, int m,
                                     int d, void* stream) {
  return dispatch<PROJ>(d, o, nullptr, nullptr, w, b, x, gamma, out, m, 1.f,
                        0.f, stream);
}
