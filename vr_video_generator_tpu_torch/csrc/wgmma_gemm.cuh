// A bf16 GEMM core for Hopper (sm_90a) on TMA and wgmma: C (M x N) =
// epilogue(bf16(A (M x K) B^T)), A and B both K-major (B is an nn.Linear
// weight, (N, K)), f32 accumulation over the whole of K, rounded to bf16
// once before the epilogue, C bf16.
//
// Design: a persistent kernel, one block of three warpgroups on each SM,
// walking 128 x 256 tiles of C in order (tile i, i + grid, ...), the N tiles
// of one row band consecutive, so the blocks in flight share their A rows in
// L2 and B stays in L2.
//   - Warp 0, the producer: one thread issues TMA loads (2-D tensor maps,
//     128-byte swizzle, 64-element K slices: a 128 x 64 A tile and a 256 x
//     64 B tile a stage) into a ring of STAGES buffers behind full/empty
//     mbarrier pairs, running ahead across tiles.
//   - Warpgroups 1 and 2, the consumers, each own 64 rows of the tile: four
//     wgmma.m64n256k16 a stage from shared memory into 128 f32 accumulators
//     a thread, one group kept in flight while the next is issued, a stage
//     released as soon as its group has retired. After the last stage they
//     round the sums to bf16 into a staging tile in shared memory (the
//     128-byte swizzle of the output's tensor map) and go on to the next
//     tile's products.
//   - Warps 1-3, the epilogue, apply the epilogue functor to the staged
//     tile, 8 values a step, in place, and store it by TMA (64 x 64 boxes,
//     rows >= M clipped), then free the staging tile. So one tile's
//     epilogue runs under the next tile's products. Where the functor is
//     costly (fc1's GELU), three warps cannot keep up with the products,
//     and the consumers finish the tile's first CONSUMER_BOXES 64-column
//     boxes themselves, from their registers, after staging the rest.
// TMA zero-fills A rows >= M and B rows >= N, and clips the stored rows >= M
// and columns >= N, so M is any count and N any multiple of 8 (a ragged last
// column tile: its columns >= N are neither finished nor stored). A gated
// epilogue (Epilogue::GATED, SwiGLU's gate) takes a product tile whose 256
// B rows are two 128-row boxes of one (2N, K) B, rows [n0, n0 + 128) and
// [N + n0, N + n0 + 128): a consumer thread holding column c of the first
// half holds column c + 128 of the second (8-column groups j and j + 16), so
// C's tile is the 128 columns [n0, n0 + 128), half the staging tile's, and
// the epilogue takes the sums of both halves (N a multiple of 128). The
// ring's and the staging tile's mbarriers (full/empty per stage;
// staged/done/free for the tile) carry phases across tiles. Every thread has 168 registers (65536 / 384): enough for a
// consumer's 128 accumulators, so no setmaxnreg (ptxas allocates a
// warpgroup's registers within the launch bound's cap whatever setmaxnreg
// later grants: a fourth warpgroup, at 128 registers a thread, could not
// compile the m64n256k16 product).
//
// An epilogue is a struct with
//   static constexpr int CONSUMER_BOXES;  // boxes of C's tile the consumers
//                                         // finish: 0-3, gated 0-1
//   static constexpr bool GATED;
//   const bf16* bias;                     // the bias it adds
//   template <int N>
//   __device__ void operator()(bf16 (&v)[N], int row, int col) const
// turning the bf16 sums v of C[row, col : col + N] (N = 2 from the
// consumers, 8 from the epilogue warps; v 4N-byte aligned) into the bf16
// outputs there; rows may be >= M (their results are clipped), columns are
// < N. A gated one's operator() takes (v, u, row, col), u the sums of the
// second half's column, and writes C into v.

#pragma once

#include <cuda_bf16.h>

#include "gemm.cuh"
#include "hopper.cuh"

namespace vrvg {
namespace tma_gemm {

constexpr int BM = 128, BN = 256, BK = 64;  // block tile, K slice a stage
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;  // warpgroups, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + producer and epilogue
constexpr int EPILOGUE_THREADS = 96;            // warps 1-3
constexpr uint32_t A_BYTES = BM * BK * 2;  // 16 KB
constexpr uint32_t B_BYTES = BN * BK * 2;  // 32 KB
constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
constexpr uint32_t C_OFF = STAGES * STAGE_BYTES;
// One 64-row x 64-column bf16 box of C: 128-byte rows. The staging tile is
// [consumer][64-column box][row][128 bytes].
constexpr uint32_t BOX_BYTES = 64 * 128;
constexpr uint32_t C_BYTES = BM * BN * 2;  // 64 KB
constexpr uint32_t BAR_OFF = C_OFF + C_BYTES;
// full[STAGES], empty[STAGES], staged, done, free; +1024 to align the
// tiles to the swizzle atom.
constexpr size_t SMEM_BYTES = BAR_OFF + 8 * (2 * STAGES + 3) + 1024;
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

template <int N>
struct Bits;  // N bf16 values as one load
template <>
struct Bits<2> {
  typedef unsigned int T;
};
template <>
struct Bits<8> {
  typedef uint4 T;
};

// The N bf16 values at p (4N-byte aligned) through the read-only cache.
template <int N>
__device__ __forceinline__ void load_bf16(bf16 (&v)[N], const bf16* p) {
  typedef typename Bits<N>::T T;
  *reinterpret_cast<T*>(v) = __ldg(reinterpret_cast<const T*>(p));
}

// Register layout of the wgmma accumulator (64 x 256) of a warpgroup:
// thread (warp w, lane l) holds rows r0 = 16 w + l / 4 and r0 + 8; value
// 4 j + 2 i + c sits at row r0 + 8 i, column 8 j + 2 (l % 4) + c.
template <class Epilogue>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tc, int m, int n, int k,
                const Epilogue epi) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + BAR_OFF;  // + 8 s
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_staged = bar_empty + 8 * STAGES;  // rest staged
  const uint32_t bar_done = bar_staged + 8;   // consumers' boxes finished
  const uint32_t bar_free = bar_done + 8;     // staging tile stored
  constexpr bool GATED = Epilogue::GATED;
  constexpr int TN = GATED ? BN / 2 : BN;  // columns of C a tile covers
  constexpr int OUT_BOXES = TN / 64;       // its 64-column boxes a consumer
  // The boxes (and 8-column groups) the consumers finish.
  constexpr int CB = Epilogue::CONSUMER_BOXES, CJ = 8 * CB;
  static_assert(CB >= 0 && CB < OUT_BOXES, "the epilogue warps keep a box");

  const int tiles_n = (n + TN - 1) / TN;
  const int tiles = tiles_n * ((m + BM - 1) / BM);
  const int k_tiles = k / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * CONSUMERS);  // one per consumer warp
    }
    mbar_init(bar_staged, 128 * CONSUMERS);  // every consumer thread
    mbar_init(bar_done, 128 * CONSUMERS);
    mbar_init(bar_free, 1);                  // the epilogue's storing thread
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      uint32_t it = 0;  // K slices loaded, over all tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * TN;
        for (int t = 0; t < k_tiles; ++t, ++it) {
          const uint32_t s = it % STAGES;
          const uint32_t sb = base + s * STAGE_BYTES;
          mbar_wait(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * s, STAGE_BYTES);
          tma_load_2d(sb, &ta, t * BK, m0, bar_full + 8 * s);
          tma_load_2d(sb + A_BYTES, &tb, t * BK, n0, bar_full + 8 * s);
          if (GATED) {
            tma_load_2d(sb + A_BYTES + B_BYTES / 2, &tb, t * BK, n + n0,
                        bar_full + 8 * s);
          }
        }
      }
    }
  } else if (wg > 0) {
    const int cw = wg - 1;  // this consumer's 64 rows of the tile
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int quad = lane & 3;
    const int r0 = warp * 16 + (lane >> 2);
    unsigned char* staged = smem + C_OFF + cw * (BN / 64) * BOX_BYTES;
    uint32_t it = 0;  // K slices consumed, over all tiles
    float acc[128];
    int j = 0;  // this block's tiles so far
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
      const int row0 = tile / tiles_n * BM + cw * 64 + r0;
      const int col0 = tile % tiles_n * TN + 2 * quad;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int t = 0; t < k_tiles; ++t, ++it) {
        const uint32_t s = it % STAGES;
        mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
        const uint32_t a = base + s * STAGE_BYTES + cw * 64 * 128;
        const uint64_t da = sw128_desc(a, 16);
        const uint64_t db = sw128_desc(base + s * STAGE_BYTES + A_BYTES, 16);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // A k-step of 16 is 32 bytes along the 128-byte swizzled row.
          wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk, 1);
        }
        wgmma_commit();
        // The previous slice's group has retired: hand its buffer back.
        wgmma_wait<1>();
        fence_regs(acc);
        if (t > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % STAGES));
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % STAGES));

      // The sums, rounded to bf16, into the staging tile once the epilogue
      // has stored the previous one: the epilogue warps' boxes first (both
      // halves' in a gated tile), then the consumers' own, finished here.
      mbar_wait(bar_free, (j & 1) ^ 1);
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        if (jj % (TN / 8) < CJ) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = r0 + 8 * i;
          *reinterpret_cast<uint32_t*>(
              staged + (jj / 8) * BOX_BYTES + r * 128 +
              (((jj % 8) ^ (r & 7)) << 4) + quad * 4) =
              pack_bf16(acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]);
        }
      }
      mbar_arrive(bar_staged);
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) {
        if (col0 + 8 * jj >= n) continue;  // past a ragged last tile
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = r0 + 8 * i;
          const int q = 4 * jj + 2 * i;
          __align__(8) bf16 v[2] = {rbf(acc[q]), rbf(acc[q + 1])};
          if constexpr (GATED) {
            // The second half's sums: group jj + 16, 64 values on.
            __align__(8) bf16 u[2] = {rbf(acc[q + 64]), rbf(acc[q + 65])};
            epi(v, u, row0 + 8 * i, col0 + 8 * jj);
          } else {
            epi(v, row0 + 8 * i, col0 + 8 * jj);
          }
          *reinterpret_cast<uint32_t*>(
              staged + (jj / 8) * BOX_BYTES + r * 128 +
              (((jj % 8) ^ (r & 7)) << 4) + quad * 4) =
              *reinterpret_cast<const uint32_t*>(v);
        }
      }
      if (CJ > 0) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(bar_done);
    }
  } else {
    const int tid = threadIdx.x - 32;  // this epilogue thread, 0..95
    int j = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * TN;
      mbar_wait(bar_staged, j & 1);
      // 16-byte unit p of the staging tile: consumer p / 2048, box
      // (p / 512) % 4, row (p / 8) % 64, swizzled unit p % 8. Each
      // consumer's half leaves SPAN units of C, past its first CB boxes; a
      // gated tile's second half sits two boxes (1024 units) on.
      constexpr int SPAN = (OUT_BOXES - CB) * 512;
#pragma unroll 4
      for (int l = tid; l < CONSUMERS * SPAN; l += EPILOGUE_THREADS) {
        const int p = l / SPAN * 2048 + CB * 512 + l % SPAN;
        const int r = (p >> 3) & 63;
        const int row = m0 + (p >> 11) * 64 + r;
        const int col = n0 + ((p >> 9) & 3) * 64 + (((p & 7) ^ (r & 7)) << 3);
        if (col >= n) continue;  // past a ragged last tile: not stored
        uint4* unit = reinterpret_cast<uint4*>(smem + C_OFF) + p;
        __align__(16) bf16 v[8];
        *reinterpret_cast<uint4*>(v) = *unit;
        if constexpr (GATED) {
          __align__(16) bf16 u[8];
          *reinterpret_cast<uint4*>(u) = unit[1024];
          epi(v, u, row, col);
        } else {
          epi(v, row, col);
        }
        *unit = *reinterpret_cast<const uint4*>(v);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, %0;" ::"n"(EPILOGUE_THREADS) : "memory");
      if (tid == 0) {
        mbar_wait(bar_done, j & 1);
#pragma unroll
        for (int cw = 0; cw < CONSUMERS; ++cw) {
          if (m0 + cw * 64 >= m) continue;
#pragma unroll
          for (int q = 0; q < OUT_BOXES; ++q) {
            if (n0 + 64 * q >= n) continue;
            tma_store_2d(&tc,
                         base + C_OFF + (cw * (BN / 64) + q) * BOX_BYTES,
                         n0 + 64 * q, m0 + cw * 64);
          }
        }
        tma_store_wait();
        mbar_arrive(bar_free);
      }
    }
  }
}

// (rows, cols) bf16, row-major, as a 2-D tensor map with (box_rows,
// box_cols) boxes (box_cols * 2 = 128 bytes), 128-byte swizzle, zero fill.
inline bool make_map_2d(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                        int rows, int cols, uint32_t box_rows,
                        uint32_t box_cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// C (M, N) = epi(bf16(A (M, K) B (N, K)^T)) on `stream`, or for a gated
// epilogue epi of the two halves of bf16(A B^T) with B (2N, K); N a multiple
// of 8 (gated: of 128), K of 64, every pointer 16-byte aligned. Returns a
// CUDA error code.
template <class Epilogue>
int gemm(const void* a, const void* b, void* c, int m, int n, int k,
         const Epilogue& epi, void* stream) {
  constexpr bool GATED = Epilogue::GATED;
  constexpr int TN = GATED ? BN / 2 : BN;
  if (m <= 0) return (int)cudaSuccess;
  if (n <= 0 || n % (GATED ? TN : 8) != 0 || k <= 0 || k % BK != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap ta, tb, tc;
  if (!make_map_2d(encode, &ta, a, m, k, BM, BK) ||
      !make_map_2d(encode, &tb, b, GATED ? 2 * n : n, k, TN, BK) ||
      !make_map_2d(encode, &tc, c, m, n, 64, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(gemm_kernel<Epilogue>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
  }
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + TN - 1) / TN * ((m + BM - 1) / BM);
  const int grid = tiles < sms ? tiles : sms;
  gemm_kernel<Epilogue><<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      ta, tb, tc, m, n, k, epi);
  return (int)cudaGetLastError();
}

// out = x + gamma * (bf16(sums) + bias), each operation rounded to bf16:
// the down projection of the MLP and SwiGLU halves (rows 9 and 10) with
// LayerScale and the residual; x and out (M, D).
struct LayerScaleResidual {
  static constexpr int CONSUMER_BOXES = 0;
  static constexpr bool GATED = false;
  const bf16* bias;
  const bf16* gamma;
  const bf16* x;
  int m, d;
  template <int N>
  __device__ __forceinline__ void operator()(bf16 (&v)[N], int row,
                                             int col) const {
    if (row >= m) return;  // clipped by the store
    __align__(16) bf16 b[N];
    __align__(16) bf16 g[N];
    __align__(16) bf16 xr[N];
    load_bf16(b, bias + col);
    load_bf16(g, gamma + col);
    load_bf16(xr, x + (long long)row * d + col);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      v[e] = add_bf(xr[e], mul_bf(g[e], add_bf(v[e], b[e])));
    }
  }
};

}  // namespace tma_gemm
}  // namespace vrvg
