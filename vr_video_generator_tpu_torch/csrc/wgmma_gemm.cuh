// A bf16 GEMM core for Hopper (sm_90a) on TMA and wgmma: C (M x N) =
// epilogue(bf16(A (M x K) B^T)), A and B both K-major (B is an nn.Linear
// weight, (N, K)), f32 accumulation over the whole of K, rounded to bf16
// once before the epilogue, C bf16.
//
// Design: a persistent kernel, one block of three warpgroups on each SM,
// walking BM x BN tiles of C in order (tile i, i + grid, ...), the N tiles
// of one row band consecutive, so the blocks in flight share their A rows in
// L2 and B stays in L2. The tile shape is a template parameter (Tile): 128
// x 256 for the dense rows (5, 6, 8, 9, 10); 256 x 128 and 128 x 192 for
// the convolutions of rows 7 and 11 (C2 = 64 or 128, and 192 output
// channels) and row 7's out_conv mix; 128 x 192 and 128 x 128 for row 8's
// fc2 at D = 384 and 128; 256 x 64 and 128 x 128 for row 16's convs (C =
// 64, and C / 128 column tiles at any wider multiple of 64).
//   - Warp 0, the producer: one thread issues TMA loads (128-byte swizzle,
//     64-element K slices: a BM x 64 A tile and a BN x 64 B tile a stage)
//     into a ring of STAGES buffers behind full/empty mbarrier pairs,
//     running ahead across tiles.
//   - Warpgroups 1 and 2, the consumers, each own BM / 2 rows of the tile:
//     MW = BM / 128 wgmma.m64nBNk16 products a K step of 16 from shared
//     memory into MW * BN / 2 f32 accumulators a thread (at most 128), one
//     group kept in flight while the next is issued, a stage released as
//     soon as its group has retired. After the last stage they round the
//     sums to bf16 into a staging tile in shared memory (the 128-byte
//     swizzle of the output's tensor map) and go on to the next tile's
//     products.
//   - Warps 1-3, the epilogue, apply the epilogue functor to the staged
//     tile, 8 values a step, in place, and store it by TMA (64-column boxes,
//     rows past the end clipped), then free the staging tile. So one tile's
//     epilogue runs under the next tile's products. Where the functor is
//     costly (fc1's GELU), three warps cannot keep up with the products,
//     and the consumers finish the tile's first CONSUMER_BOXES 64-column
//     boxes themselves, from their registers, after staging the rest.
// Where A comes from and where C goes is the Layout: DenseLayout reads A as
// a 2-D (M, K) matrix and stores C as a 2-D (M, N) one; Conv3x3Layout makes
// the product a 3x3 convolution with zero padding of a (B, H, W, C) image,
// read in place (an implicit GEMM, below).
// TMA zero-fills A rows >= M and B rows >= N, and clips the stored rows >= M
// and columns >= N, so M is any count and N any multiple of 8 (a ragged last
// column tile: its columns >= N are neither finished nor stored). A gated
// epilogue (Epilogue::GATED, SwiGLU's gate) takes a product tile whose BN
// B rows are two BN / 2-row boxes of one (2N, K) B, rows [n0, n0 + BN / 2)
// and [N + n0, N + n0 + BN / 2): a consumer thread holding column c of the
// first half holds column c + BN / 2 of the second, so C's tile is the BN / 2
// columns [n0, n0 + BN / 2), half the staging tile's, and the epilogue takes
// the sums of both halves (N a multiple of BN / 2). The ring's and the
// staging tile's mbarriers (full/empty per stage; staged/done/free for the
// tile) carry phases across tiles. Every thread has 168 registers (65536 /
// 384): enough for a consumer's 128 accumulators, so no setmaxnreg (ptxas
// allocates a warpgroup's registers within the launch bound's cap whatever
// setmaxnreg later grants: a fourth warpgroup, at 128 registers a thread,
// could not compile the m64n256k16 product).
//
// An epilogue is a struct with
//   static constexpr int CONSUMER_BOXES;  // boxes of C's tile the consumers
//                                         // finish: 0-3, gated 0-1
//   static constexpr bool GATED;
//   static constexpr bool F32_STEP;       // an f32 step on the sums before
//                                         // their cast (below)
//   const bf16* bias;                     // the bias it adds
//   template <int N>
//   __device__ void operator()(bf16 (&v)[N], int row, int col) const
// turning the bf16 sums v of C[row, col : col + N] (N = 2 from the
// consumers, 8 from the epilogue warps; v 4N-byte aligned) into the bf16
// outputs there; rows may be >= M (their results are clipped), columns are
// < N. A gated one's operator() takes (v, u, row, col), u the sums of the
// second half's column, and writes C into v. One with F32_STEP (row 7's
// conv1, whose f32 bias is added before the cast; row 16's convs, whose
// bias, ReLU and residuals all come before it) also has
//   __device__ void f32_step(float& v0, float& v1, int row, int col) const
// which the consumers apply to the f32 sums of C[row, col : col + 2] as
// they leave the registers, before the one rounding to bf16 (row is the
// GEMM row: a Conv3x3Layout's tiles map it to a pixel); every other
// epilogue leaves that code out at compile time.

#pragma once

#include <cuda_bf16.h>

#include "gemm.cuh"
#include "hopper.cuh"

namespace vrvg {
namespace tma_gemm {

constexpr int BK = 64;        // K slice a stage
constexpr int CONSUMERS = 2;  // warpgroups, BM / 2 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + producer and epilogue
constexpr int EPILOGUE_THREADS = 96;            // warps 1-3
constexpr size_t SMEM_LIMIT = 232448;           // one block's on an H100

// The block tile: BM (128 or 256) rows by BN (64 to 256) columns. A
// consumer's BM / 2 rows are MW products of 64 rows; MW * BN / 2 f32
// accumulators a thread. The staging tile is [consumer][64-column box][row
// of the consumer's BM / 2][128 bytes]; the ring takes as many stages (3 or
// 4) as fit beside it.
template <int BM_, int BN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int MW = BM / 128;
  static_assert((BM == 128 || BM == 256) && BN % 64 == 0 && MW * BN <= 256,
                "tile shape");
  static constexpr uint32_t A_BYTES = BM * BK * 2;
  static constexpr uint32_t B_BYTES = BN * BK * 2;
  static constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr uint32_t BOX_BYTES = 64 * MW * 128;
  static constexpr uint32_t C_BYTES = BM * BN * 2;
  static constexpr int FIT =
      (int)((SMEM_LIMIT - 1024 - 128 - C_BYTES) / STAGE_BYTES);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr uint32_t C_OFF = STAGES * STAGE_BYTES;
  static constexpr uint32_t BAR_OFF = C_OFF + C_BYTES;
  // full[STAGES], empty[STAGES], staged, done, free; +1024 to align the
  // tiles to the swizzle atom.
  static constexpr size_t SMEM_BYTES = BAR_OFF + 8 * (2 * STAGES + 3) + 1024;
  static_assert(STAGES >= 3 && SMEM_BYTES <= SMEM_LIMIT, "shared memory");
};
typedef Tile<128, 256> Wide;  // the dense rows' tile

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

// A (rows, K) and C (rows, N), row-major, as 2-D tensor maps: A's box is
// BM rows of one K slice, C's 64 rows of 64 columns.
struct DenseLayout {
  int rows;
  template <int BM>
  __device__ __forceinline__ void load_a(uint32_t dst, const CUtensorMap* ta,
                                         int t, int m0, uint32_t bar) const {
    tma_load_2d(dst, ta, t * BK, m0, bar);
  }
  // Store the staged 64 x 64 box at src as C[row0 : row0 + 64, col : col +
  // 64] (rows past the end clipped).
  template <int BM>
  __device__ __forceinline__ void store_c(const CUtensorMap* tc, uint32_t src,
                                          int col, int row0) const {
    if (row0 < rows) tma_store_2d(tc, src, col, row0);
  }
};

// A 3x3 convolution with zero padding as an implicit GEMM: C (B, H, W, N) =
// conv(U (B, H, W, C), w) with w (N, 9 C), k = (3 dh + dw) C + c. A tile of
// BM GEMM rows is a rectangle of BM / P image rows by P pixels of one frame,
// in (row, pixel) order; tiles run along W, then H, then the frames. K slice
// t is tap t / (C / 64), channels 64 (t mod C / 64): A's tile is one box of
// (64 channels, P pixels, BM / P rows, 1 frame) of U's 4-D tensor map at
// (c0, x0 + dw - 1, y0 + dh - 1, b). TMA reads coordinates outside the image
// as zeros, which is the padding. C is stored through a 4-D (N, W, H, B) map
// in boxes of (64, P, 64 / P, 1), so pixels and rows past the image are
// clipped: a ragged tile wastes the products of its P-pixel (and BM /
// P-row) overhang, 3% at W = 528. One box a stage: on an H100, conv1 at
// vitl-518 took 2.19 ms with eight 32-pixel boxes a stage and 1.86 ms with
// four 64-pixel ones.
struct Conv3x3Layout {
  static constexpr int P = 32;
  int rows;      // tiles * BM
  int c_slices;  // C / 64
  int tiles_x;   // tiles along W
  int tiles_y;   // tiles along H
  template <int BM>
  __device__ __forceinline__ void load_a(uint32_t dst, const CUtensorMap* ta,
                                         int t, int m0, uint32_t bar) const {
    const int tap = t / c_slices;
    const int c0 = (t - tap * c_slices) * 64;
    const int dh = tap / 3, dw = tap - 3 * dh;
    const int tile = m0 / BM;
    const int ty = tile / tiles_x;
    tma_load_4d(dst, ta, c0, (tile - ty * tiles_x) * P + dw - 1,
                ty % tiles_y * (BM / P) + dh - 1, ty / tiles_y, bar);
  }
  // The 64 staged rows from GEMM row row0 (a multiple of 64): 64 / P image
  // rows of the tile.
  template <int BM>
  __device__ __forceinline__ void store_c(const CUtensorMap* tc, uint32_t src,
                                          int col, int row0) const {
    const int tile = row0 / BM;
    const int ty = tile / tiles_x;
    tma_store_4d(tc, src, col, (tile - ty * tiles_x) * P,
                 ty % tiles_y * (BM / P) + row0 % BM / P, ty / tiles_y);
  }
};

// Register layout of a wgmma accumulator (64 x BN) of a warpgroup: thread
// (warp w, lane l) holds rows r0 = 16 w + l / 4 and r0 + 8; value 4 j + 2 i
// + c sits at row r0 + 8 i, column 8 j + 2 (l % 4) + c.
template <class Epilogue, class Shape, class Layout>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tc, int n, int k,
                const Layout lay, const Epilogue epi) {
  constexpr int BM = Shape::BM, BN = Shape::BN, MW = Shape::MW;
  constexpr int STAGES = Shape::STAGES;
  constexpr uint32_t STAGE_BYTES = Shape::STAGE_BYTES;
  constexpr uint32_t A_BYTES = Shape::A_BYTES, B_BYTES = Shape::B_BYTES;
  constexpr uint32_t BOX_BYTES = Shape::BOX_BYTES, C_OFF = Shape::C_OFF;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + Shape::BAR_OFF;  // + 8 s
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_staged = bar_empty + 8 * STAGES;  // rest staged
  const uint32_t bar_done = bar_staged + 8;   // consumers' boxes finished
  const uint32_t bar_free = bar_done + 8;     // staging tile stored
  constexpr bool GATED = Epilogue::GATED;
  constexpr int TN = GATED ? BN / 2 : BN;  // columns of C a tile covers
  constexpr int OUT_BOXES = TN / 64;       // its 64-column boxes a consumer
  constexpr int ROWS = 64 * MW;            // a consumer's rows
  // The boxes (and 8-column groups) the consumers finish.
  constexpr int CB = Epilogue::CONSUMER_BOXES, CJ = 8 * CB;
  static_assert(CB >= 0 && CB < OUT_BOXES, "the epilogue warps keep a box");

  const int tiles_n = (n + TN - 1) / TN;
  const int tiles = tiles_n * ((lay.rows + BM - 1) / BM);
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
          lay.template load_a<BM>(sb, &ta, t, m0, bar_full + 8 * s);
          tma_load_2d(sb + A_BYTES, &tb, t * BK, n0, bar_full + 8 * s);
          if (GATED) {
            tma_load_2d(sb + A_BYTES + B_BYTES / 2, &tb, t * BK, n + n0,
                        bar_full + 8 * s);
          }
        }
      }
    }
  } else if (wg > 0) {
    const int cw = wg - 1;  // this consumer's BM / 2 rows of the tile
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int quad = lane & 3;
    const int r0 = warp * 16 + (lane >> 2);
    unsigned char* staged = smem + C_OFF + cw * (BN / 64) * BOX_BYTES;
    uint32_t it = 0;  // K slices consumed, over all tiles
    float acc[MW][BN / 2];
    int j = 0;  // this block's tiles so far
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
      const int row0 = tile / tiles_n * BM + cw * ROWS + r0;
      const int col0 = tile % tiles_n * TN + 2 * quad;
#pragma unroll
      for (int mw = 0; mw < MW; ++mw)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mw][i] = 0.f;
      for (int t = 0; t < k_tiles; ++t, ++it) {
        const uint32_t s = it % STAGES;
        mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
        const uint32_t a = base + s * STAGE_BYTES + cw * ROWS * 128;
        const uint64_t db = sw128_desc(base + s * STAGE_BYTES + A_BYTES, 16);
#pragma unroll
        for (int mw = 0; mw < MW; ++mw) fence_regs(acc[mw]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int mw = 0; mw < MW; ++mw) {
            // A k-step of 16 is 32 bytes along the 128-byte swizzled row.
            const uint64_t da = sw128_desc(a + mw * 64 * 128, 16);
            wgmma_m64k16<BN>(acc[mw], da + 2 * kk, db + 2 * kk, 1);
          }
        }
        wgmma_commit();
        // The previous slice's group has retired: hand its buffer back.
        wgmma_wait<1>();
#pragma unroll
        for (int mw = 0; mw < MW; ++mw) fence_regs(acc[mw]);
        if (t > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % STAGES));
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mw = 0; mw < MW; ++mw) fence_regs(acc[mw]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % STAGES));
      if constexpr (Epilogue::F32_STEP) {
        static_assert(!GATED, "a gated epilogue has no f32 step");
#pragma unroll
        for (int mw = 0; mw < MW; ++mw) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int jj = 0; jj < BN / 8; ++jj) {
              // Columns past a ragged last tile are neither finished nor
              // stored: they take column n - 2's operands, so the unrolled
              // loop has no branch and the step's loads issue together.
              const int q = 4 * jj + 2 * i;
              epi.f32_step(acc[mw][q], acc[mw][q + 1],
                           row0 + mw * 64 + 8 * i, min(col0 + 8 * jj, n - 2));
            }
          }
        }
      }

      // The sums, rounded to bf16, into the staging tile once the epilogue
      // has stored the previous one: the epilogue warps' boxes first (both
      // halves' in a gated tile), then the consumers' own, finished here.
      mbar_wait(bar_free, (j & 1) ^ 1);
#pragma unroll
      for (int mw = 0; mw < MW; ++mw) {
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj) {
          if (jj % (TN / 8) < CJ) continue;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = mw * 64 + r0 + 8 * i;
            *reinterpret_cast<uint32_t*>(
                staged + (jj / 8) * BOX_BYTES + r * 128 +
                (((jj % 8) ^ (r & 7)) << 4) + quad * 4) =
                pack_bf16(acc[mw][4 * jj + 2 * i],
                          acc[mw][4 * jj + 2 * i + 1]);
          }
        }
      }
      mbar_arrive(bar_staged);
#pragma unroll
      for (int mw = 0; mw < MW; ++mw) {
#pragma unroll
        for (int jj = 0; jj < CJ; ++jj) {
          if (col0 + 8 * jj >= n) continue;  // past a ragged last tile
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = mw * 64 + r0 + 8 * i;
            const int q = 4 * jj + 2 * i;
            __align__(8) bf16 v[2] = {rbf(acc[mw][q]), rbf(acc[mw][q + 1])};
            if constexpr (GATED) {
              // The second half's sums: TN / 8 groups, TN / 2 values on.
              __align__(8) bf16 u[2] = {rbf(acc[mw][q + TN / 2]),
                                        rbf(acc[mw][q + TN / 2 + 1])};
              epi(v, u, row0 + mw * 64 + 8 * i, col0 + 8 * jj);
            } else {
              epi(v, row0 + mw * 64 + 8 * i, col0 + 8 * jj);
            }
            *reinterpret_cast<uint32_t*>(
                staged + (jj / 8) * BOX_BYTES + r * 128 +
                (((jj % 8) ^ (r & 7)) << 4) + quad * 4) =
                *reinterpret_cast<const uint32_t*>(v);
          }
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
      // 16-byte unit p of the staging tile: consumer p / CONS_UNITS, box
      // (p / BOX_UNITS) % (BN / 64), row (p / 8) % ROWS, swizzled unit p %
      // 8. Each consumer's part leaves SPAN units of C, past its first CB
      // boxes; a gated tile's second half sits TN / 64 boxes on.
      constexpr int BOX_UNITS = BOX_BYTES / 16;
      constexpr int CONS_UNITS = BOX_UNITS * (BN / 64);
      constexpr int SPAN = (OUT_BOXES - CB) * BOX_UNITS;
#pragma unroll 4
      for (int l = tid; l < CONSUMERS * SPAN; l += EPILOGUE_THREADS) {
        const int p = l / SPAN * CONS_UNITS + CB * BOX_UNITS + l % SPAN;
        const int r = (p / 8) % ROWS;
        const int row = m0 + p / CONS_UNITS * ROWS + r;
        const int col = n0 + (p / BOX_UNITS) % (BN / 64) * 64 +
                        (((p & 7) ^ (r & 7)) << 3);
        if (col >= n) continue;  // past a ragged last tile: not stored
        uint4* unit = reinterpret_cast<uint4*>(smem + C_OFF) + p;
        __align__(16) bf16 v[8];
        *reinterpret_cast<uint4*>(v) = *unit;
        if constexpr (GATED) {
          __align__(16) bf16 u[8];
          *reinterpret_cast<uint4*>(u) = unit[(TN / 64) * BOX_UNITS];
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
#pragma unroll
          for (int q = 0; q < OUT_BOXES; ++q) {
            if (n0 + 64 * q >= n) continue;
#pragma unroll
            for (int mw = 0; mw < MW; ++mw) {
              lay.template store_c<BM>(
                  &tc,
                  base + C_OFF + (cw * (BN / 64) + q) * BOX_BYTES +
                      mw * 64 * 128,
                  n0 + 64 * q, m0 + cw * ROWS + mw * 64);
            }
          }
        }
        tma_store_wait();
        mbar_arrive(bar_free);
      }
    }
  }
}

// A tensor map of bf16 `dims` (innermost first; byte strides of the outer
// axes), `box` elements a box, 128-byte swizzle (box[0] * 2 = 128 bytes),
// out-of-bounds reads as zeros.
template <int R>
inline bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                     const cuuint64_t (&dims)[R],
                     const cuuint64_t (&strides)[R - 1],
                     const cuuint32_t (&box)[R]) {
  cuuint32_t elem[R];
  for (int i = 0; i < R; ++i) elem[i] = 1;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, R,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (rows, cols) bf16, row-major, as a 2-D tensor map with (box_rows,
// box_cols) boxes (box_cols * 2 = 128 bytes).
inline bool make_map_2d(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                        int rows, int cols, uint32_t box_rows,
                        uint32_t box_cols) {
  return make_map<2>(encode, map, ptr, {(cuuint64_t)cols, (cuuint64_t)rows},
                     {(cuuint64_t)cols * 2}, {box_cols, box_rows});
}

// Launch the persistent kernel over the tiles of `lay` (one block an SM at
// most) on `stream`. Returns a CUDA error code.
template <class Epilogue, class Shape, class Layout>
int launch_tiles(const CUtensorMap& ta, const CUtensorMap& tb,
                 const CUtensorMap& tc, int n, int k, const Layout& lay,
                 const Epilogue& epi, void* stream) {
  constexpr int TN = Epilogue::GATED ? Shape::BN / 2 : Shape::BN;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(gemm_kernel<Epilogue, Shape, Layout>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Shape::SMEM_BYTES);
  }
  if (err != cudaSuccess) return (int)err;
  const int tiles =
      (n + TN - 1) / TN * ((lay.rows + Shape::BM - 1) / Shape::BM);
  const int grid = tiles < sms ? tiles : sms;
  gemm_kernel<Epilogue, Shape, Layout>
      <<<grid, THREADS, Shape::SMEM_BYTES, (cudaStream_t)stream>>>(
          ta, tb, tc, n, k, lay, epi);
  return (int)cudaGetLastError();
}

// C (M, N) = epi(bf16(A (M, K) B (N, K)^T)), or for a gated epilogue epi of
// the two halves of bf16(A B^T) with B (2N, K); N a multiple of 8 (gated: of
// Shape::BN / 2), K of 64, every pointer 16-byte aligned. On Shape's tiles
// (128 x 256 unless given). Returns a CUDA error code.
template <class Shape = Wide, class Epilogue>
int gemm(const void* a, const void* b, void* c, int m, int n, int k,
         const Epilogue& epi, void* stream) {
  constexpr bool GATED = Epilogue::GATED;
  constexpr int TN = GATED ? Shape::BN / 2 : Shape::BN;
  if (m <= 0) return (int)cudaSuccess;
  if (n <= 0 || n % (GATED ? TN : 8) != 0 || k <= 0 || k % BK != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap ta, tb, tc;
  if (!make_map_2d(encode, &ta, a, m, k, Shape::BM, BK) ||
      !make_map_2d(encode, &tb, b, GATED ? 2 * n : n, k, TN, BK) ||
      !make_map_2d(encode, &tc, c, m, n, 64, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_tiles<Epilogue, Shape>(ta, tb, tc, n, k, DenseLayout{m}, epi,
                                       stream);
}

// out (B, H, W, N) = epi(bf16(conv3x3(u (B, H, W, C), w))) with zero
// padding, w (N, 9 C) with k = (3 dh + dw) C + c (Conv3x3Layout), on Shape's
// tiles; C a multiple of 64, N of 8, every pointer 16-byte aligned. Returns
// a CUDA error code.
template <class Shape, class Epilogue>
int conv3x3(const void* u, const void* w, void* out, int batch, int h,
            int width, int c, int n, const Epilogue& epi, void* stream) {
  static_assert(!Epilogue::GATED, "a convolution's epilogue is not gated");
  constexpr int P = Conv3x3Layout::P;
  if (batch <= 0 || h <= 0 || width <= 0) return (int)cudaSuccess;
  if (c <= 0 || c % BK != 0 || n <= 0 || n % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t px = (cuuint64_t)c * 2, row = px * width;
  const cuuint64_t opx = (cuuint64_t)n * 2, orow = opx * width;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)width, (cuuint64_t)h,
                              (cuuint64_t)batch};
  const cuuint64_t odims[4] = {(cuuint64_t)n, dims[1], dims[2], dims[3]};
  CUtensorMap ta, tb, tc;
  if (!make_map<4>(encode, &ta, u, dims, {px, row, row * h},
                   {64, P, Shape::BM / P, 1}) ||
      !make_map_2d(encode, &tb, w, n, 9 * c, Shape::BN, BK) ||
      !make_map<4>(encode, &tc, out, odims, {opx, orow, orow * h},
                   {64, P, 64 / P, 1})) {
    return (int)cudaErrorInvalidValue;
  }
  Conv3x3Layout lay;
  lay.c_slices = c / BK;
  lay.tiles_x = (width + P - 1) / P;
  lay.tiles_y = (h + Shape::BM / P - 1) / (Shape::BM / P);
  lay.rows = batch * lay.tiles_y * lay.tiles_x * Shape::BM;
  return launch_tiles<Epilogue, Shape>(ta, tb, tc, n, 9 * c, lay, epi,
                                       stream);
}

// The bf16 sums as they are: a product with no epilogue arithmetic (row
// 11's conv1, whose bias is not added here; row 7's out_conv mix).
struct Identity {
  static constexpr int CONSUMER_BOXES = 0;
  static constexpr bool GATED = false;
  static constexpr bool F32_STEP = false;
  const bf16* bias;  // not added; named as every epilogue's bias is
  template <int N>
  __device__ __forceinline__ void operator()(bf16 (&)[N], int, int) const {}
};

// bf16(sums + sum_bias) with an f32 bias added before the one cast: row 7's
// conv1 (head_tail_pallas.py `_tail_ext_kernel`, unlike the dense layers,
// whose bias is added to the bf16 sums).
struct BiasBeforeCast {
  static constexpr int CONSUMER_BOXES = 0;
  static constexpr bool GATED = false;
  static constexpr bool F32_STEP = true;
  const bf16* bias;  // not added; named as every epilogue's bias is
  const float* sum_bias;
  __device__ __forceinline__ void f32_step(float& v0, float& v1, int,
                                           int col) const {
    v0 = __fadd_rn(v0, __ldg(sum_bias + col));
    v1 = __fadd_rn(v1, __ldg(sum_bias + col + 1));
  }
  template <int N>
  __device__ __forceinline__ void operator()(bf16 (&)[N], int, int) const {}
};

// out = x + gamma * (bf16(sums) + bias), each operation rounded to bf16:
// the attention half's proj (row 6) and the down projections of the MLP and
// SwiGLU halves (rows 9 and 10), with LayerScale and the residual; x and out
// (M, D).
struct LayerScaleResidual {
  static constexpr int CONSUMER_BOXES = 0;
  static constexpr bool GATED = false;
  static constexpr bool F32_STEP = false;
  const bf16* bias;
  const bf16* gamma;
  const bf16* x;
  int m, d;
  template <int N>
  __device__ __forceinline__ void operator()(bf16 (&v)[N], int row,
                                             int col) const {
    if (row >= m) return;  // clipped by the store
    apply(v, row, col);
  }
  // The arithmetic at a row < M.
  template <int N>
  __device__ __forceinline__ void apply(bf16 (&v)[N], int row,
                                        int col) const {
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
