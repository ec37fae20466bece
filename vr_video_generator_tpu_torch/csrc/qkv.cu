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
// against ~61 MB, balanced (18 us either way). proj is 5.8 GFLOP against
// ~45 MB at vits: memory-bound.
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
// proj's design: one block of 8 warps per (64-row, 128-column) output tile,
// the block's 64 A rows in shared memory for the whole K, weight tiles of
// 128 x 64 streamed through shared memory, each warp a 32 x 32 sub-tile
// (2 x 2 wmma fragments). Simple first: no cp.async pipelining, wmma
// instead of wgmma/TMA.

#include "wgmma_gemm.cuh"

extern "C" int vrvg_layernorm(const void* x, const void* w, const void* b,
                              void* y, int m, int d, float eps, void* stream);

namespace {

using namespace vrvg;

constexpr int BM = 64, BN = 128, BK = 64;
constexpr int THREADS = 256;
constexpr int LDB = BK + 16;
constexpr int LDC = BN + 8;

using tma_gemm::load_bf16;

// ln_qkv's epilogue: [q * scale | k | v] = bf16(a w^T) + bias, q's columns
// (< d) scaled in f32 and rounded back.
struct QkvEpilogue {
  static constexpr int CONSUMER_BOXES = 0;
  static constexpr bool GATED = false;
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

// out (M, D) = resid + gamma * (a @ w^T + bias).
template <int D>
__global__ void __launch_bounds__(THREADS)
proj_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
            const bf16* __restrict__ bias, const bf16* __restrict__ resid,
            const bf16* __restrict__ gamma, bf16* __restrict__ out, int m) {
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

  load_rows(As, LDA, a + row0 * D, D, BM, D, valid, tid, THREADS);

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
      const bf16 t = add_bf(rbf(Cs[r * LDC + c + e]), bias[n + e]);
      v[e] = add_bf(resid[row * D + n + e], mul_bf(gamma[n + e], t));
    }
    *reinterpret_cast<uint4*>(out + row * D + n) =
        *reinterpret_cast<const uint4*>(v);
  }
}

template <int D>
int run_proj(const void* o, const void* x, const void* w, const void* bias,
             const void* gamma, void* out, int m, void* stream) {
  dim3 grid((m + BM - 1) / BM, D / BN);
  return launch(proj_kernel<D>, grid, THREADS, smem_bytes<D>(), stream,
                (const bf16*)o, (const bf16*)w, (const bf16*)bias,
                (const bf16*)x, (const bf16*)gamma, (bf16*)out, m);
}

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
// b (D,), gamma (D,) bf16 -> out (M, D) bf16 = x + gamma * (o w^T + b). D in
// {128, 384, 768, 1024}.
extern "C" int vrvg_proj_ls_residual(const void* o, const void* x,
                                     const void* w, const void* b,
                                     const void* gamma, void* out, int m,
                                     int d, void* stream) {
  switch (d) {
    case 128: return run_proj<128>(o, x, w, b, gamma, out, m, stream);
    case 384: return run_proj<384>(o, x, w, b, gamma, out, m, stream);
    case 768: return run_proj<768>(o, x, w, b, gamma, out, m, stream);
    case 1024: return run_proj<1024>(o, x, w, b, gamma, out, m, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
