// The SwiGLU half-block of the vitg (DINOv2-giant) blocks, for Hopper
// (sm_90a): out = x + gamma * (w3(silu(x1) * x2) + b3), [x1 | x2] =
// w12(LN2(x)) + b12, as a chain of three kernels:
//
//   1. ln:   LN2 of each row, f32 statistics and the f32 affine -> bf16 h
//   2. gate: h . w12^T on the tensor cores, f32 sums -> bf16, + b12 in bf16,
//            then silu(x1) * x2 -> bf16 g                        (M, H)
//   3. down: g . w3^T, f32 sums over all of H -> bf16 once, + b3, gamma * .
//            and x + ., each rounded to bf16                     (M, D)
//
// Replaces: vr_video_generator_tpu/ops/mlp_pallas.py `_swiglu_kernel` (row
// 10, swiglu_residual_pallas), at its rounding points. x1 is the first half
// of w12's outputs (rows [0, H) of the upstream `mlp.w12.weight`), as
// jnp.split(t, 2) takes it. silu is rounded as XLA rounds jax.nn.silu on
// bf16: it evaluates logistic(x) as 1 / (1 + exp(-x)) with a bf16 rounding
// after the exp, the add and the divide, then rounds x * s, then the
// product with x2 (ops/mlp.silu_mul); expf and IEEE division, no fast math.
// The TPU kernel accumulates w3 in f32 over hidden chunks and casts once; the
// down kernel's f32 sum over all of H is the same rounding point.
//
// What bounds it on the H100: at 1080p/vitg (B = 8, M = 8 * 2443 rows, D =
// 1536, H = 4096) the two products are 737.6 GFLOP (0.75 ms at the 989
// TFLOP/s bf16 peak) against 60 MB of x in and 60 MB out: compute-bound.
//
// Design. The TPU kernel keeps the (rows, H) hidden activations in VMEM. The
// same plan on a GPU (csrc/mlp.cu, row 9) does not fit at D = 1536: the LN'd
// rows of a 32-row block (99 KB), the two w12 projections of a 32-wide
// hidden chunk (199 KB) and the w3 chunk (123 KB) are far over the 227 KB a
// block may have, and the (32 x 1536) f32 w3 accumulator is 96 registers a
// thread at 512 threads, against the 128 that __launch_bounds__(512, 1)
// allows. Rather than 16-row blocks (twice the L2 traffic of weights) or
// output columns split across blocks (w12 and the SwiGLU recomputed, 1.67x
// the FLOPs), the chain writes h (M x D bf16, 60 MB) and g (M x H, 160 MB)
// to device memory and reads each back once: ~0.13 ms of traffic at 3.35
// TB/s, under a fifth of the bound. Each product is then a plain tiled GEMM:
// 128 x 128 output tiles, 8 warps of 32 x 64, K in slices of 64 staged in
// shared memory (36,864 bytes), f32 accumulators in registers (64 a thread).
// The gate tile's 128 columns are 64 hidden columns of x1 and the same 64 of
// x2, so each warp holds both halves of its 32 x 32 outputs and applies the
// SwiGLU in its epilogue. Simple first: no cp.async pipelining, wmma and not
// wgmma or TMA. ptxas: gate 124 and down 126 registers (two blocks an SM
// under __launch_bounds__(256, 2)), LayerNorm 74, no spills. Measured at
// 1080p/vitg, B = 8 (NVIDIA H100 80GB HBM3, 700.00 W): 5.76 ms a launch,
// 128 TFLOP/s, 7.7x the bound (PERF.md).

#include "gemm.cuh"

namespace {

using namespace vrvg;

constexpr int THREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LD = BK + 8;    // bf16 pitch of a staged K-slice row
constexpr int LN_ROWS = THREADS / WARP;  // one warp a row
constexpr size_t TILE = align128((size_t)BM * LD * 2);
constexpr size_t SMEM = 2 * TILE;  // the A and the B slice
static_assert(BM == BN, "A and B slices share one size");
static_assert((size_t)(THREADS / WARP) * 512 * 4 <= SMEM, "epilogue staging");

// silu(x1) * x2 at XLA's bf16 rounding points (see the header).
__device__ __forceinline__ bf16 silu_mul(bf16 x1, bf16 x2) {
  const float x = bf(x1);
  const bf16 e = rbf(expf(-x));
  const bf16 a = rbf(__fadd_rn(1.f, bf(e)));
  const bf16 s = rbf(__fdiv_rn(1.f, bf(a)));
  return mul_bf(rbf(__fmul_rn(x, bf(s))), x2);
}

// 1. LayerNorm, one warp a row -> h.
template <int D>
__global__ void __launch_bounds__(THREADS)
ln_kernel(const bf16* __restrict__ x, const float* __restrict__ lnw,
          const float* __restrict__ lnb, bf16* __restrict__ h, int m,
          float eps) {
  const long long row0 = (long long)blockIdx.x * LN_ROWS;
  const int valid = (int)min((long long)LN_ROWS, (long long)m - row0);
  layernorm_rows<D>(h + row0 * D, D, x + row0 * D, valid, valid, lnw, lnb,
                    eps);
}

// Stage the K-slice [k0, k0 + BK) of the block's BM rows of A (rows at or
// past `valid` as zeros) and of B's two runs of BN / 2 weight rows.
__device__ __forceinline__ void load_slice(bf16* As, bf16* Bs, const bf16* a,
                                           int valid, const bf16* b_lo,
                                           const bf16* b_hi, int k, int k0) {
  const int tid = threadIdx.x;
  load_rows(As, LD, a + k0, k, BM, BK, valid, tid, THREADS);
  load_rows(Bs, LD, b_lo + k0, k, BN / 2, BK, BN / 2, tid, THREADS);
  load_rows(Bs + (BN / 2) * LD, LD, b_hi + k0, k, BN / 2, BK, BN / 2, tid,
            THREADS);
}

// 2. g = silu(x1) * x2. Grid (H / 64 hidden tiles, M / BM row tiles); the
// tile's B rows are w12 rows [n0, n0 + 64) (x1) and [H + n0, H + n0 + 64)
// (x2). Warp (wm, wn) owns rows wm * 32 + [0, 32) and hidden columns
// n0 + wn * 32 + [0, 32) of both halves.
template <int D, int H>
__global__ void __launch_bounds__(THREADS, 2)
gate_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w12,
            const bf16* __restrict__ b12, bf16* __restrict__ g, int m) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + TILE);
  const int n0 = blockIdx.x * (BN / 2);
  const long long row0 = (long long)blockIdx.y * BM;
  const int valid = (int)min((long long)BM, (long long)m - row0);
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int wm = warp / 2, wn = warp % 2;

  FragC t1[2][2], t2[2][2];
  zero(t1);
  zero(t2);
#pragma unroll 1
  for (int k0 = 0; k0 < D; k0 += BK) {
    __syncthreads();  // the previous slice fully consumed
    load_slice(As, Bs, h + row0 * D, valid, w12 + (long long)n0 * D,
               w12 + (long long)(H + n0) * D, D, k0);
    __syncthreads();
    const bf16* a = As + wm * 32 * LD;
    mma_block<2, 2, BK>(t1, a, LD, Bs + wn * 32 * LD, LD);
    mma_block<2, 2, BK>(t2, a, LD, Bs + (BN / 2 + wn * 32) * LD, LD);
  }

  // Epilogue through two per-warp 16 x 16 f32 staging tiles.
  __syncthreads();
  float* st = reinterpret_cast<float*>(smem) + warp * 512;
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, t1[i][j], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(st + 256, t2[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long row = row0 + wm * 32 + i * 16 + r;
      if (row < m) {
        const int col = n0 + wn * 32 + j * 16 + c;
        __align__(16) bf16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bf16 x1 = add_bf(rbf(st[r * 16 + c + e]), b12[col + e]);
          const bf16 x2 = add_bf(rbf(st[256 + r * 16 + c + e]), b12[H + col + e]);
          v[e] = silu_mul(x1, x2);
        }
        *reinterpret_cast<uint4*>(g + row * H + col) =
            *reinterpret_cast<const uint4*>(v);
      }
      __syncwarp();
    }
  }
}

// 3. out = x + gamma * (g . w3^T + b3). Grid (D / BN column tiles, M / BM
// row tiles); warp (wm, wn) owns rows wm * 32 + [0, 32) and output columns
// n0 + wn * 64 + [0, 64).
template <int D, int H>
__global__ void __launch_bounds__(THREADS, 2)
down_kernel(const bf16* __restrict__ g, const bf16* __restrict__ w3,
            const bf16* __restrict__ b3, const bf16* __restrict__ gamma,
            const bf16* __restrict__ x, bf16* __restrict__ out, int m) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + TILE);
  const int n0 = blockIdx.x * BN;
  const long long row0 = (long long)blockIdx.y * BM;
  const int valid = (int)min((long long)BM, (long long)m - row0);
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int wm = warp / 2, wn = warp % 2;

  FragC acc[2][4];
  zero(acc);
#pragma unroll 1
  for (int k0 = 0; k0 < H; k0 += BK) {
    __syncthreads();  // the previous slice fully consumed
    load_slice(As, Bs, g + row0 * H, valid, w3 + (long long)n0 * H,
               w3 + (long long)(n0 + BN / 2) * H, H, k0);
    __syncthreads();
    mma_block<2, 4, BK>(acc, As + wm * 32 * LD, LD, Bs + wn * 64 * LD, LD);
  }

  // Epilogue through a per-warp 16 x 16 f32 staging tile.
  __syncthreads();
  float* st = reinterpret_cast<float*>(smem) + warp * 512;
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long row = row0 + wm * 32 + i * 16 + r;
      if (row < m) {
        const int col = n0 + wn * 64 + j * 16 + c;
        const long long off = row * D + col;
        __align__(16) bf16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bf16 y = add_bf(rbf(st[r * 16 + c + e]), b3[col + e]);
          v[e] = add_bf(x[off + e], mul_bf(gamma[col + e], y));
        }
        *reinterpret_cast<uint4*>(out + off) = *reinterpret_cast<const uint4*>(v);
      }
      __syncwarp();
    }
  }
}

template <int D, int H>
int run(const void* x, const void* lnw, const void* lnb, const void* w12,
        const void* b12, const void* w3, const void* b3, const void* gamma,
        void* h, void* g, void* out, int m, float eps, void* stream) {
  static_assert(D % BN == 0 && D % BK == 0 && H % (BN / 2) == 0 &&
                H % BK == 0, "tile sizes");
  const unsigned row_tiles = (m + BM - 1) / BM;
  int err = launch(ln_kernel<D>, dim3((m + LN_ROWS - 1) / LN_ROWS), THREADS,
                   0, stream, (const bf16*)x, (const float*)lnw,
                   (const float*)lnb, (bf16*)h, m, eps);
  if (err) return err;
  err = launch(gate_kernel<D, H>, dim3(H / (BN / 2), row_tiles), THREADS,
               SMEM, stream, (const bf16*)h, (const bf16*)w12,
               (const bf16*)b12, (bf16*)g, m);
  if (err) return err;
  return launch(down_kernel<D, H>, dim3(D / BN, row_tiles), THREADS, SMEM,
                stream, (const bf16*)g, (const bf16*)w3, (const bf16*)b3,
                (const bf16*)gamma, (const bf16*)x, (bf16*)out, m);
}

}  // namespace

// x (M, D) bf16, LN affine (D,) f32, w12 (2H, D) and b12 (2H,), w3 (D, H),
// b3 (D,), gamma (D,) bf16; scratch h (M, D) and g (M, H) bf16 -> out (M, D)
// bf16. D = 1536 with H = 4096 (vitg).
extern "C" int vrvg_swiglu_residual(const void* x, const void* lnw,
                                    const void* lnb, const void* w12,
                                    const void* b12, const void* w3,
                                    const void* b3, const void* gamma,
                                    void* h, void* g, void* out, int m, int d,
                                    int hidden, float eps, void* stream) {
  if (d == 1536 && hidden == 4096)
    return run<1536, 4096>(x, lnw, lnb, w12, b12, w3, b3, gamma, h, g, out, m,
                           eps, stream);
  return (int)cudaErrorInvalidValue;
}
