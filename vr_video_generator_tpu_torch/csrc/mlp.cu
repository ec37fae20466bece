// The MLP half-block of the DINOv2 blocks in one kernel, for Hopper
// (sm_90a): out = x + gamma * (fc2(GELU(fc1(LN2(x))))), at D <= 768.
//
// Replaces: vr_video_generator_tpu/ops/mlp_pallas.py `_kernel_resident`
// (row 8: mlp_residual_pallas with the weights resident in VMEM, taken at
// vits and vitb). Rounding points as there and as flax's nn.Dense: LN with
// f32 statistics and the f32 affine, cast to bf16; fc1 accumulates in f32,
// is cast to bf16, then + b1 in bf16; the GELU is the A&S erf of
// ops/gelu.py evaluated in f32 (gemm.cuh's gelu_as) and cast to bf16; fc2
// accumulates its partial products over the hidden chunks in f32, is cast to
// bf16 once, + b2, gamma * . and x + . each round to bf16. Row 9 (the
// hidden-blocked body `_kernel`, vitl's D = 1024) is csrc/mlp_hblocked.cu.
//
// What bounds it on the H100: at 1080p/vits (M = 8 * 2443 rows, D = 384,
// hidden 1536) the two GEMMs are 46 GFLOP (47 us at the 989 TFLOP/s bf16
// peak), while the kernel must move only x in and the output out (~30 MB):
// compute-bound, once the (M, 4D) hidden activations stay on the chip. The
// unfused path writes and re-reads them in f32 and bf16 several times (the
// A&S GELU alone is ~10 elementwise passes).
//
// Design: one block of 8 warps per BM rows. The block LNs its rows into
// shared memory, then walks the hidden dimension in HC-wide chunks: the fc1
// chunk (BM x HC, f32 in shared memory) -> bias, GELU -> a bf16 chunk in
// shared memory -> its fc2 partial product, accumulated in registers (each
// warp owns D / 8 output columns). On a GPU every width is hidden-blocked
// this way: a block streams each chunk's weights from L2 into shared memory,
// so the TPU's resident/blocked split becomes a choice of tile sizes. The
// (BM x D) f32 accumulator is what sets them, at most 96 f32 a thread:
//   D <= 384: BM = 64, HC = 64;  D = 768: BM = 32, HC = 32.
// Simple first: each chunk's weights are loaded whole into shared memory
// before use (no pipelining), wmma instead of wgmma/TMA.

#include "gemm.cuh"

namespace {

using namespace vrvg;

template <int D>
struct Plan {
  static constexpr int THREADS = 256;
  static constexpr int NWARPS = THREADS / WARP;
  static constexpr int BM = D <= 384 ? 64 : 32;
  static constexpr int HC = D <= 384 ? 64 : 32;
  static constexpr int H = 4 * D;
  static constexpr int LDA = D + 16;   // LN rows, and the fc1 weight chunk
  static constexpr int LDW2 = HC + 16;  // fc2 weight chunk
  static constexpr int LDG = HC + 16;  // GELU chunk
  static constexpr int LDS = HC + 8;   // f32 fc1 chunk
  static constexpr int MI2 = BM / 16, NJ2 = D / NWARPS / 16;
  static constexpr size_t A = align128((size_t)BM * LDA * 2);
  static constexpr size_t W1 = align128((size_t)HC * LDA * 2);
  static constexpr size_t W2 = align128((size_t)D * LDW2 * 2);
  static constexpr size_t G = align128((size_t)BM * LDG * 2);
  static constexpr size_t S = align128((size_t)BM * LDS * 4);
  static constexpr size_t SMEM = A + W1 + W2 + G + S;
  static_assert(D % (NWARPS * 16) == 0, "D must split into 16-wide warp tiles");
  static_assert(W1 >= (size_t)NWARPS * 256 * 4, "epilogue staging");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

template <int D>
__global__ void __launch_bounds__(Plan<D>::THREADS, 1)
mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ lnw,
           const float* __restrict__ lnb, const bf16* __restrict__ w1,
           const bf16* __restrict__ b1, const bf16* __restrict__ w2,
           const bf16* __restrict__ b2, const bf16* __restrict__ gamma,
           bf16* __restrict__ out, int m, float eps) {
  typedef Plan<D> P_;
  constexpr int BM = P_::BM, HC = P_::HC, H = P_::H;
  constexpr int THREADS = P_::THREADS, NWARPS = P_::NWARPS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* W1s = reinterpret_cast<bf16*>(smem + P_::A);
  bf16* W2s = reinterpret_cast<bf16*>(smem + P_::A + P_::W1);
  bf16* Gs = reinterpret_cast<bf16*>(smem + P_::A + P_::W1 + P_::W2);
  float* Ss = reinterpret_cast<float*>(smem + P_::A + P_::W1 + P_::W2 + P_::G);

  const int tid = threadIdx.x;
  const int warp = tid / WARP, lane = tid % WARP;
  const long long row0 = (long long)blockIdx.x * BM;
  const int valid = (int)min((long long)BM, (long long)m - row0);
  const int col0 = warp * (D / NWARPS);  // this warp's fc2 output columns

  layernorm_rows<D>(As, P_::LDA, x + row0 * D, BM, valid, lnw, lnb, eps);

  FragC acc[P_::MI2][P_::NJ2];
  zero(acc);
  for (int h0 = 0; h0 < H; h0 += HC) {
    __syncthreads();  // LN rows ready; the previous chunk fully consumed
    load_rows(W1s, P_::LDA, w1 + (long long)h0 * D, D, HC, D, HC, tid,
              THREADS);
    load_rows(W2s, P_::LDW2, w2 + h0, H, D, HC, D, tid, THREADS);
    __syncthreads();

    // fc1 chunk: (BM x D) x (D x HC) -> f32 in shared memory.
    constexpr int TN = HC / 16, TILES = (BM / 16) * TN;
    for (int t = warp; t < TILES; t += NWARPS) {
      const int tm = t / TN, tn = t % TN;
      FragC c[1][1];
      zero(c);
      mma_block<1, 1, D>(c, As + tm * 16 * P_::LDA, P_::LDA,
                         W1s + tn * 16 * P_::LDA, P_::LDA);
      store(Ss + tm * 16 * P_::LDS + tn * 16, P_::LDS, c);
    }
    __syncthreads();

    // bf16(fc1) + b1 -> GELU -> bf16.
    for (int i = tid; i < BM * HC; i += THREADS) {
      const int r = i / HC, c = i % HC;
      const bf16 t = add_bf(rbf(Ss[r * P_::LDS + c]), b1[h0 + c]);
      Gs[r * P_::LDG + c] = rbf(gelu_as(bf(t)));
    }
    __syncthreads();

    // fc2 partial: (BM x HC) x (HC x D), f32 accumulation in registers.
    mma_block<P_::MI2, P_::NJ2, HC>(acc, Gs, P_::LDG,
                                    W2s + col0 * P_::LDW2, P_::LDW2);
  }

  // Epilogue through a per-warp 16 x 16 f32 staging tile (in W1s, free now).
  __syncthreads();
  float* st = reinterpret_cast<float*>(W1s) + warp * 256;
#pragma unroll
  for (int i = 0; i < P_::MI2; ++i) {
#pragma unroll
    for (int j = 0; j < P_::NJ2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = lane / 2, c = (lane % 2) * 8;
      const int row = i * 16 + r;
      if (row < valid) {
        const int col = col0 + j * 16 + c;
        const long long off = (row0 + row) * D + col;
        __align__(16) bf16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bf16 y = add_bf(rbf(st[r * 16 + c + e]), b2[col + e]);
          v[e] = add_bf(x[off + e], mul_bf(gamma[col + e], y));
        }
        *reinterpret_cast<uint4*>(out + off) = *reinterpret_cast<const uint4*>(v);
      }
      __syncwarp();
    }
  }
}

template <int D>
int run(const void* x, const void* lnw, const void* lnb, const void* w1,
        const void* b1, const void* w2, const void* b2, const void* gamma,
        void* out, int m, float eps, void* stream) {
  dim3 grid((m + Plan<D>::BM - 1) / Plan<D>::BM);
  return launch(mlp_kernel<D>, grid, Plan<D>::THREADS, Plan<D>::SMEM, stream,
                (const bf16*)x, (const float*)lnw, (const float*)lnb,
                (const bf16*)w1, (const bf16*)b1, (const bf16*)w2,
                (const bf16*)b2, (const bf16*)gamma, (bf16*)out, m, eps);
}

}  // namespace

// x (M, D) bf16, LN affine (D,) f32, w1 (4D, D), b1 (4D,), w2 (D, 4D),
// b2 (D,), gamma (D,) bf16 -> out (M, D) bf16. D in {128, 384, 768}.
extern "C" int vrvg_mlp_residual(const void* x, const void* lnw,
                                 const void* lnb, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, const void* gamma, void* out,
                                 int m, int d, float eps, void* stream) {
  switch (d) {
    case 128: return run<128>(x, lnw, lnb, w1, b1, w2, b2, gamma, out, m, eps, stream);
    case 384: return run<384>(x, lnw, lnb, w1, b1, w2, b2, gamma, out, m, eps, stream);
    case 768: return run<768>(x, lnw, lnb, w1, b1, w2, b2, gamma, out, m, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
