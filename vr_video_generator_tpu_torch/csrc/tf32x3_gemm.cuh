// An f32-accurate GEMM core on the tensor cores for Hopper (sm_90a), by
// 3xTF32: C (M x N) = epilogue(A (M x K) B^T), A f32 (a row-major matrix, or
// the im2col of an NHWC image read in place: a 3x3 convolution as an
// implicit GEMM), B an nn.Linear weight (N, K) or a conv's (N, 9 C) given as
// its TF32 split (split_kernel), sums f32, C f32. Rows 5 and 6 at f32
// (csrc/qkv_f32.cu) and rows 8, 9 and 10 at f32 (csrc/mlp_f32.cu,
// csrc/swiglu_f32.cu) run their products on it; rows 11 and 12 at f32 their
// two convs and row 7 at f32 its out_conv mix and two convs
// (csrc/head_tail_big.cu, vrvg_head_tail_big_f32, vrvg_head_tail_ext_f32),
// row 15 at f32 its two convs (vrvg_head_tail_f32); row 16 at f32 its four
// convs (csrc/rcu_pair_f32.cu).
//
// Why 3xTF32: wgmma takes no f32 operands, and TF32 keeps 10 mantissa bits.
// Each operand x is the sum of two TF32 values hi + lo (csrc/tf32x3.cuh,
// |x - hi - lo| <= 2^-22 |x|), and a b = (a_lo b_hi + a_hi b_lo) + a_hi b_hi
// to about 2^-21 |a||b| a term: three TF32 products at the card's 495
// TFLOP/s make 165 TFLOP/s of f32-accurate product, against 67 TFLOP/s on
// the CUDA cores (an FFMA core reached 38-44). At vitg-518's row 10 (M =
// 19544, D = 1536, H = 4096) the two products are 737.7 GFLOP: 4.47 ms at
// 165 TFLOP/s, against 0.25 ms for its f32 bytes: bound by operations.
//
// Design: a persistent kernel, one block of two warpgroups on each SM,
// walking 128 x BN tiles of C: gemm_kernel at BN = 128 for the dense rows;
// conv_kernel for a 3x3 conv at BN = 32, 64 or 96, the width that covers
// its N with few idle columns.
//   - The weights are split once, not at every call: split_kernel writes
//     B's hi plane then its lo plane, (2, Npad, K) TF32 bit patterns, Npad
//     = N rounded up to 128 with zero rows; for row 10's gate, w12's rows
//     in tf32x3::gated_row's order (x1 and x2 of 64 hidden columns a
//     128-row tile). The caller keeps the result with the weight
//     (ops/mlp.tf32x3_weight, ops/head_tail._conv_split).
//   - Thread 0 keeps a ring of STAGES stages full by TMA (128-byte swizzle,
//     f32 boxes of 32 columns): a dense stage is A's 128 x 32 tile and
//     B_hi's and B_lo's 128 x 32 tiles, 48 KB, behind full/empty
//     mbarriers, running ahead across tiles. It refills a slot while its
//     own warpgroup's products of the next stage run. There is no producer
//     warp: ptxas sizes registers by whole warpgroups, so a 288-thread
//     block gets the 168 of 384 threads, and spilled at BN = 128. A conv's
//     stage is only B's tiles for one (tap, 32-channel slice), A coming
//     from a ring of halos, one a slice; its narrower tiles fit in 168
//     registers, and it has a producer warp (see conv_kernel).
//   - Each warpgroup owns 64 rows of the tile. At each stage it
//     reads its A fragment from shared memory (wgmma's .tf32 register
//     layout; the 128-byte swizzle keeps the 32 lanes on 32 banks), splits
//     it in registers into hi and lo (tf32x3::split), and issues twelve
//     wgmma.m64nBNk8.tf32, B from shared memory: lo.hi and hi.lo over the
//     stage's four k-steps, then hi.hi, the small terms first, into a fresh
//     accumulator. It waits for them, releases the stage, and adds the
//     accumulator into its running f32 sums by FADD. The tensor core's own
//     f32 accumulation truncates, and an attention output summed on it over
//     75 tiles drifted to 1.8e-5-3.4e-5 of |o| (csrc/attention_f32.cu), so
//     no sum on the core runs longer than one stage: 32 of K, 12 products.
//     The two warpgroups share the SM's tensor cores, so one's wait,
//     release, FADD and A split run under the other's products.
//   - After the tile's last stage the warpgroups apply the epilogue to
//     their running sums from registers and store C as f32 pairs (or, for
//     a ROW epilogue, gather each row's BN sums into one thread of its quad
//     by shuffles, in column order); the ring already holds the next
//     tile's first stages.
//   - Tiles run in groups of column tiles whose hi/lo B panel fits in
//     GROUP_BYTES of L2, each group walked row band by row band: the
//     blocks in flight share that panel and A's row bands. (w12's hi and
//     lo take 100 MB, twice the 50 MB L2, so a band-by-band order would
//     read all of B from device memory once per band.) A conv's panel (at
//     most 192 x 3456 x 8 bytes) fits whole, so its tiles run along W,
//     then H, then the frames, and the blocks in flight share image rows.
// Registers: a thread holds BN / 2 accumulators, BN / 2 running sums and
// the A fragment's 16 hi and 16 lo values: 193-228 registers at BN = 128
// (gemm_kernel, of the 255 that 256 threads leave; 228 with half-stage
// sums), 101-164 at BN = 32-96 (conv_kernel, of the 168 that its 288
// threads leave; 137-138 with row 16's RcuEpi), no spills (ptxas, sm_90a).
//
// Register layout of a wgmma f32 accumulator (64 x BN) in a warpgroup:
// thread (warp w, lane l) holds rows r0 = 16 w + l / 4 and r0 + 8; value
// 4 j + 2 i + c sits at row r0 + 8 i, column 8 j + 2 (l % 4) + c. Columns
// c and c + 64 are in one thread (j and j + 8): a gated epilogue takes x1
// from j < 8 and x2 from j + 8.
//
// An epilogue is a struct with
//   static constexpr bool GATED, ROW;
//   int n;  // C's columns (gated: H, the hidden columns of g)
// and, neither gated nor ROW,
//   __device__ void store(int row, int col, float v0, float v1) const;
// given the f32 sums of C[row, col : col + 2] (row < M, col < N, col even);
// gated,
//   __device__ void store(int row, int col, float x1_0, float x1_1,
//                         float x2_0, float x2_1) const;
// given the sums of x1 and x2 of hidden columns col, col + 1 (col < H);
// ROW (N = BN, one column tile),
//   __device__ void store_row(int row, const float (&v)[BN]) const;
// given the row's N sums in column order. It writes C itself, with its
// arithmetic from csrc/epilogue_f32.cuh. `row` is A's row, or for a conv
// the output pixel (b H + y) W + x.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue_f32.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {
namespace tf32x3_gemm {

using namespace vrvg;

constexpr int BM = 128;  // C rows a tile: two consumer warpgroups of 64
constexpr int BN = 128;  // C columns a tile of the dense product
constexpr int BK = 32;   // K a stage: one 128-byte swizzled row of f32
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * CONSUMERS;
constexpr int STAGES = 4;
constexpr uint32_t A_BYTES = BM * BK * 4;  // 16 KB
constexpr uint32_t B_BYTES = BN * BK * 4;  // 16 KB, each of hi and lo
constexpr uint32_t STAGE_BYTES = A_BYTES + 2 * B_BYTES;
constexpr uint32_t BAR_OFF = STAGES * STAGE_BYTES;
// full[STAGES], empty[STAGES]; +1024 to align the tiles to the swizzle
// atom.
constexpr size_t SMEM_BYTES = BAR_OFF + 8 * 2 * STAGES + 1024;
constexpr long long GROUP_BYTES = 16ll << 20;  // a group's B panel, hi + lo
constexpr int SPLIT_THREADS = 256;

// Rows of the split B operand: N rounded up to 128; gated (row 10's w12
// with H hidden columns), 128 ceil(H / 64).
inline int split_rows(int rows, int hidden) {
  return hidden > 0 ? 128 * ((hidden + 63) / 64) : (rows + BN - 1) / BN * BN;
}

// w (rows, K) f32 -> out: hi plane (npad, K) then lo plane (npad, K), TF32
// bit patterns; row p of each holds w's row p (hidden = 0) or
// tf32x3::gated_row(p, hidden), zeros where it has none. K a multiple of 4.
__global__ void __launch_bounds__(SPLIT_THREADS)
    split_kernel(const float* __restrict__ w, uint32_t* __restrict__ out,
                 int rows, int k, int npad, int hidden) {
  const long long units = (long long)npad * k / 4;
  for (long long e = blockIdx.x * (long long)SPLIT_THREADS + threadIdx.x;
       e < units; e += (long long)gridDim.x * SPLIT_THREADS) {
    const long long idx = 4 * e;
    const int p = (int)(idx / k), kk = (int)(idx - (long long)p * k);
    const int src = hidden > 0 ? tf32x3::gated_row(p, hidden)
                               : (p < rows ? p : -1);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src >= 0) {
      v = *reinterpret_cast<const float4*>(w + (long long)src * k + kk);
    }
    uint4 hi, lo;
    tf32x3::split(v.x, hi.x, lo.x);
    tf32x3::split(v.y, hi.y, lo.y);
    tf32x3::split(v.z, hi.z, lo.z);
    tf32x3::split(v.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(out + idx) = hi;
    *reinterpret_cast<uint4*>(out + (long long)npad * k + idx) = lo;
  }
}

// Split w (rows, K) f32 into `out` ((2, split_rows(rows, hidden), K) 32-bit
// words) on `stream`. Returns a CUDA error code.
inline int split(const float* w, uint32_t* out, int rows, int k, int hidden,
                 void* stream) {
  if (rows <= 0 || k <= 0 || k % 4 || hidden < 0 ||
      (hidden > 0 && rows != 2 * hidden)) {
    return (int)cudaErrorInvalidValue;
  }
  const int npad = split_rows(rows, hidden);
  const long long units = (long long)npad * k / 4;
  long long blocks = (units + SPLIT_THREADS - 1) / SPLIT_THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  split_kernel<<<(int)blocks, SPLIT_THREADS, 0, (cudaStream_t)stream>>>(
      w, out, rows, k, npad, hidden);
  return (int)cudaGetLastError();
}

// Tile `tile` of the walk -> its row tile and its first column: groups of
// `group` column tiles (the last one narrower), each walked row tile by row
// tile.
template <int TN>
__device__ __forceinline__ void tile_origin(int tile, int tiles_m,
                                            int tiles_n, int group, int& tm,
                                            int& n0) {
  const int per = group * tiles_m;
  const int g = tile / per, r = tile - g * per;
  const int width = min(group, tiles_n - g * group);
  tm = r / width;
  n0 = (g * group + r % width) * TN;
}

// This thread's A fragment of a stage, split: its rows are `row` and row +
// 8 of the 128-byte swizzled tile at `tile` (A's rows r0 and r0 + 8; or a
// halo's rows for a tap), and k-step kk's registers 4 kk + 2 c + i hold
// A[row + 8 i][8 kk + quad + 4 c], in the order wgmma takes them. A row is
// 32 floats in eight 16-byte units, unit u at u ^ (row & 7) ((row + 8) & 7
// too); k-slot 8 kk + quad + 4 c is unit 2 kk + c.
__device__ __forceinline__ void split_a(const unsigned char* tile, int row,
                                        int quad, uint32_t (&ah)[16],
                                        uint32_t (&al)[16]) {
  const int swz = row & 7;
  const float* arow = reinterpret_cast<const float*>(tile + row * 128);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int v = 4 * kk + 2 * c + i;
        tf32x3::split(arow[i * 8 * 32 + (((2 * kk + c) ^ swz) << 2) + quad],
                      ah[v], al[v]);
      }
    }
  }
}

// A stage's products of k-steps K0 .. K0 + KN - 1 (all four by default:
// twelve products) into a fresh accumulator, B_hi's and B_lo's BN x 32 tiles
// at bh and bl: lo.hi and hi.lo over the k-steps, then hi.hi, committed as
// one group.
template <int BN, int K0 = 0, int KN = 4>
__device__ __forceinline__ void issue_stage(float (&acc)[BN / 2],
                                            uint32_t (&ah)[16],
                                            uint32_t (&al)[16], uint32_t bh,
                                            uint32_t bl) {
  fence_regs(acc);
  fence_regs(ah);
  fence_regs(al);
  wgmma_fence();
  // A k-step of 8 is 32 bytes along B's 128-byte swizzled rows.
  const uint64_t dh = sw128_desc(bh, 16), dl = sw128_desc(bl, 16);
#pragma unroll
  for (int kk = K0; kk < K0 + KN; ++kk) {
    wgmma_tf32<BN>(acc, al[4 * kk], al[4 * kk + 1], al[4 * kk + 2],
                   al[4 * kk + 3], dh + 2 * kk, kk > K0);
    wgmma_tf32<BN>(acc, ah[4 * kk], ah[4 * kk + 1], ah[4 * kk + 2],
                   ah[4 * kk + 3], dl + 2 * kk, 1);
  }
#pragma unroll
  for (int kk = K0; kk < K0 + KN; ++kk) {
    wgmma_tf32<BN>(acc, ah[4 * kk], ah[4 * kk + 1], ah[4 * kk + 2],
                   ah[4 * kk + 3], dh + 2 * kk, 1);
  }
  wgmma_commit();
}

// The epilogue of a tile's running sums, this thread's rows `rows[i]` (C's
// row of accumulator row r0 + 8 i, or -1 past the end), from column n0.
template <int BN, class Epi>
__device__ __forceinline__ void store_tile(const Epi& epi,
                                           const int (&rows)[2], int n0,
                                           int lane, const float (&sum)[BN / 2]) {
  const int quad = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rows[i];
    if constexpr (Epi::ROW) {
      // Column n of the row from the quad's lane acc_lane(n): every lane
      // of the quad takes part, the lane i stores.
      float v[BN];
#pragma unroll
      for (int n = 0; n < BN; ++n) {
        v[n] = __shfl_sync(0xffffffffu, sum[tf32x3::acc_value(n, i)],
                           (lane & ~3) | tf32x3::acc_lane(n));
      }
      if (quad == i && row >= 0) epi.store_row(row, v);
    } else if constexpr (Epi::GATED) {
      if (row < 0) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 / 2 + 8 * j + 2 * quad;
        if (col < epi.n) {
          epi.store(row, col, sum[4 * j + 2 * i], sum[4 * j + 2 * i + 1],
                    sum[4 * (j + 8) + 2 * i], sum[4 * (j + 8) + 2 * i + 1]);
        }
      }
    } else {
      if (row < 0) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * quad;
        if (col < epi.n) {
          epi.store(row, col, sum[4 * j + 2 * i], sum[4 * j + 2 * i + 1]);
        }
      }
    }
  }
}

// Load stage q of this block's walk (tile blockIdx.x + (q / k_tiles)
// gridDim.x, K slice q % k_tiles) into ring slot q % STAGES: A's 128 x 32
// tile, then B_hi's and B_lo's, completing on that slot's full barrier.
__device__ __forceinline__ void load_stage(const CUtensorMap* ta,
                                           const CUtensorMap* tb,
                                           uint32_t base, uint32_t bar_full,
                                           uint32_t q, int k_tiles,
                                           int tiles_m, int tiles_n,
                                           int group, int npad) {
  int tm, n0;
  tile_origin<BN>(blockIdx.x + (int)(q / k_tiles) * gridDim.x, tiles_m,
                  tiles_n, group, tm, n0);
  const int k0 = (int)(q % k_tiles) * BK;
  const uint32_t s = q % STAGES, sb = base + s * STAGE_BYTES;
  mbar_expect_tx(bar_full + 8 * s, STAGE_BYTES);
  tma_load_2d(sb, ta, k0, tm * BM, bar_full + 8 * s);
  tma_load_2d(sb + A_BYTES, tb, k0, n0, bar_full + 8 * s);
  tma_load_2d(sb + A_BYTES + B_BYTES, tb, k0, npad + n0, bar_full + 8 * s);
}

// The dense product: C = epi(A (M, K) B^T) on 128 x 128 tiles, a fresh
// tensor-core sum every SUM_K of K (a stage, 32, or half of one, 16),
// added in f32. The tensor core truncates each k-step's add to its sum, so
// at a short K the shorter sum keeps the product as close to f32 as
// cuBLAS's SGEMM; it waits for the first half's products before issuing
// the second's.
template <class Epi, int SUM_K>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb, int m, int npad,
                int k, int group, const Epi epi) {
  static_assert(SUM_K == BK || SUM_K == BK / 2, "a stage or half of one");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + BAR_OFF;  // + 8 s
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const int tiles_m = (m + BM - 1) / BM, tiles_n = npad / BN;
  const int tiles = tiles_m * tiles_n;
  const int k_tiles = (k + BK - 1) / BK;
  // This block's stages: its tiles blockIdx.x, + gridDim.x, ... times K's.
  const uint32_t stages =
      (uint32_t)((tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                 (int)gridDim.x) * k_tiles;
  // Thread 0 keeps the ring full: the first STAGES stages now, then each
  // stage's refill once both warpgroups have released the slot.
  const bool producer = threadIdx.x == 0;

  if (producer) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * CONSUMERS);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (uint32_t q = 0; q < STAGES && q < stages; ++q) {
      load_stage(&ta, &tb, base, bar_full, q, k_tiles, tiles_m, tiles_n,
                 group, npad);
    }
  }
  __syncthreads();

  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, quad = lane & 3;
  // This thread's accumulator rows r0 and r0 + 8 of the tile.
  const int r0 = threadIdx.x / 128 * 64 + warp * 16 + (lane >> 2);
  uint32_t it = 0;  // stages consumed, over all tiles
  float acc[64], sum[64];
  uint32_t ah[16], al[16];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int tm, n0;
    tile_origin<BN>(tile, tiles_m, tiles_n, group, tm, n0);
#pragma unroll
    for (int v = 0; v < 64; ++v) sum[v] = 0.f;
    for (int t = 0; t < k_tiles; ++t, ++it) {
      const uint32_t s = it % STAGES;
      const uint32_t sb = base + s * STAGE_BYTES;
      mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
      split_a(smem + s * STAGE_BYTES, r0, quad, ah, al);
      constexpr int KN = 4 * SUM_K / BK;  // k-steps a sum
      issue_stage<BN, 0, KN>(acc, ah, al, sb + A_BYTES,
                             sb + A_BYTES + B_BYTES);
      // Under the products: refill the slot stage it - 1 used with stage
      // it - 1 + STAGES, once both warpgroups have released it.
      if (producer && it > 0 && it - 1 + STAGES < stages) {
        mbar_wait(bar_empty + 8 * ((it - 1) % STAGES),
                  ((it - 1) / STAGES) & 1);
        load_stage(&ta, &tb, base, bar_full, it - 1 + STAGES, k_tiles,
                   tiles_m, tiles_n, group, npad);
      }
      if constexpr (KN < 4) {
        __syncwarp();
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int v = 0; v < 64; ++v) sum[v] = __fadd_rn(sum[v], acc[v]);
        issue_stage<BN, KN, KN>(acc, ah, al, sb + A_BYTES,
                                sb + A_BYTES + B_BYTES);
      }
      __syncwarp();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ah);
      fence_regs(al);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
#pragma unroll
      for (int v = 0; v < 64; ++v) sum[v] = __fadd_rn(sum[v], acc[v]);
    }
    const int row = tm * BM + r0;
    const int rows[2] = {row < m ? row : -1, row + 8 < m ? row + 8 : -1};
    store_tile<BN>(epi, rows, n0, lane, sum);
  }
}

// The 3x3 conv's ring (conv_kernel): a stage is B_hi's and B_lo's BN x 32
// tiles of one (tap, 32-channel slice); a halo slot is one slice's box of
// (R + 2) x (P + 2) pixels (tf32x3::ConvTiles::halo), split in place into
// its hi plane and a lo plane beside it, which the slice's nine taps read
// at shifted rows. HALOS halo slots, and as many stages as the rest of
// CONV_RING_BYTES holds, at most 16.
constexpr uint32_t CONV_RING_BYTES = 220 * 1024;
template <int BN>
struct HaloRing {
  typedef tf32x3::ConvTiles G;
  static_assert(BN == 32 || BN == 64 || BN == 96, "tile width");
  static constexpr uint32_t HALO_BYTES = (G::R + 2) * (G::P + 2) * 128;
  static constexpr uint32_t PLANE = (HALO_BYTES + 1023) / 1024 * 1024;
  static constexpr int HALOS = 2;
  static constexpr uint32_t B_OFF = HALOS * 2 * PLANE;
  static constexpr uint32_t B_BYTES = BN * BK * 4;
  static constexpr uint32_t STAGE_BYTES = 2 * B_BYTES;
  static constexpr int FIT = (CONV_RING_BYTES - B_OFF) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 16 ? FIT : 16;
  static constexpr uint32_t BAR_OFF = B_OFF + STAGES * STAGE_BYTES;
  // full[STAGES], empty[STAGES], halo_full[HALOS], halo_empty[HALOS];
  // +1024 to align the tiles to the swizzle atom.
  static constexpr size_t SMEM_BYTES =
      BAR_OFF + 8 * 2 * (STAGES + HALOS) + 1024;
  static_assert(STAGES >= 3 && SMEM_BYTES <= 232448, "ring");
};

// This thread's A fragment of a stage from split planes: as split_a, with
// hi and lo read from the planes at `hi` and `lo` (the same layout).
__device__ __forceinline__ void load_a(const unsigned char* hi,
                                       const unsigned char* lo, int row,
                                       int quad, uint32_t (&ah)[16],
                                       uint32_t (&al)[16]) {
  const int swz = row & 7;
  const uint32_t* rh = reinterpret_cast<const uint32_t*>(hi + row * 128);
  const uint32_t* rl = reinterpret_cast<const uint32_t*>(lo + row * 128);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int v = 4 * kk + 2 * c + i;
        const int at = i * 8 * 32 + (((2 * kk + c) ^ swz) << 2) + quad;
        ah[v] = rh[at];
        al[v] = rl[at];
      }
    }
  }
}

// A 3x3 conv with zero padding as an implicit GEMM on the 3xTF32 core: C
// (B H W, N) = epi(conv(x (B, H, W, C), w)), the weights (N, 9 C) split, k
// = (3 dh + dw) C + c. A tile is 4 image rows x 32 pixels of one frame
// (tf32x3::ConvTiles). Its K walks the 32-channel slices, and each slice's
// nine taps: for each slice a producer warp loads the slice's halo (6 rows
// x 34 pixels, TMA's zero fill the padding) once, and for each (slice,
// tap) a stage of B_hi and B_lo, each as soon as both warpgroups have
// released its slot. The two consumer warpgroups split the halo into TF32
// hi and lo planes once, and load their A fragments from the planes at
// each tap's shifted rows (ConvTiles::halo_row): each image value moves
// from L2 once a slice (1.6 times its tile) and is split once, where
// per-tap boxes of A moved and split it 9 times. Measured on an H100 at
// vitb-518 (conv1 C = 128 -> 64, conv2 64 -> 32), per-tap boxes with thread
// 0 producing took 3.6-3.7 and 4.8-5.0 ms, halos split once 3.2-3.3 and
// 4.0-4.3, and with the producer warp 2.6-2.7 and 3.3-3.4. Each stage is a
// fresh sum of its twelve products, added in f32, the stages in that
// order.
constexpr int CONV_THREADS = THREADS + 32;  // + the producer warp
template <int BN, class Epi>
__global__ void __launch_bounds__(CONV_THREADS, 1)
    conv_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb,
                const tf32x3::ConvTiles g, int tiles_n, int npad,
                const Epi epi) {
  typedef HaloRing<BN> R;
  constexpr int STAGES = R::STAGES, HALOS = R::HALOS;
  static_assert(!Epi::GATED, "a conv's product is not gated");
  static_assert(!Epi::ROW || BN == 32, "a ROW epilogue takes 32 columns");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + R::BAR_OFF;  // + 8 s
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const uint32_t halo_full = bar_empty + 8 * STAGES;  // + 8 h
  const uint32_t halo_empty = halo_full + 8 * HALOS;
  const int tiles_m = g.tiles();
  const int tiles = tiles_m * tiles_n;
  const int k_tiles = 9 * (g.c / BK);  // (slice, tap) stages a tile
  // This block's stages and halos (one a slice, nine stages each).
  const uint32_t stages =
      (uint32_t)((tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                 (int)gridDim.x) * k_tiles;
  const uint32_t halos = stages / 9;
  // The B panel (at most 192 x 3456 x 8 bytes) fits in L2 whole: tiles
  // run a row tile's column tiles, then the next row tile's.
  auto origin = [&](uint32_t q, int& tm, int& n0) {
    tile_origin<BN>(blockIdx.x + (int)(q / k_tiles) * gridDim.x, tiles_m,
                    tiles_n, tiles_n, tm, n0);
  };
  // Stage q's B_hi and B_lo, (slice, tap) = t / 9, t % 9 of its tile.
  auto load_b = [&](uint32_t q) {
    int tm, n0;
    origin(q, tm, n0);
    const int t = (int)(q % k_tiles), cs = t / 9;
    const int k0 = (t - 9 * cs) * g.c + cs * BK;
    const uint32_t s = q % STAGES;
    const uint32_t sb = base + R::B_OFF + s * R::STAGE_BYTES;
    mbar_expect_tx(bar_full + 8 * s, R::STAGE_BYTES);
    tma_load_2d(sb, &tb, k0, n0, bar_full + 8 * s);
    tma_load_2d(sb + R::B_BYTES, &tb, k0, npad + n0, bar_full + 8 * s);
  };
  // Halo hq: the slice of stages 9 hq .. 9 hq + 8.
  auto load_halo = [&](uint32_t hq) {
    int tm, n0;
    origin(9 * hq, tm, n0);
    int c0, x0, y0, b;
    g.halo(tm, (int)(9 * hq % k_tiles) / 9, c0, x0, y0, b);
    const uint32_t h = hq % HALOS;
    mbar_expect_tx(halo_full + 8 * h, R::HALO_BYTES);
    tma_load_4d(base + 2 * h * R::PLANE, &ta, c0, x0, y0, b,
                halo_full + 8 * h);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * CONSUMERS);  // one per warp
    }
    for (int h = 0; h < HALOS; ++h) {
      mbar_init(halo_full + 8 * h, 1);
      mbar_init(halo_empty + 8 * h, 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= THREADS) {
    // The producer warp: each slot refilled as soon as both warpgroups
    // have released it (a fresh barrier's "previous" phase counts as
    // released), a slice's halo before its first stage.
    if (threadIdx.x == THREADS) {
      for (uint32_t q = 0; q < stages; ++q) {
        if (q % 9 == 0) {
          const uint32_t hq = q / 9;
          mbar_wait(halo_empty + 8 * (hq % HALOS), ((hq / HALOS) & 1) ^ 1);
          load_halo(hq);
        }
        mbar_wait(bar_empty + 8 * (q % STAGES), ((q / STAGES) & 1) ^ 1);
        load_b(q);
      }
    }
    return;
  }

  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, quad = lane & 3;
  // This thread's accumulator rows r0 and r0 + 8 of the tile.
  const int r0 = threadIdx.x / 128 * 64 + warp * 16 + (lane >> 2);
  uint32_t it = 0;  // stages consumed, over all tiles
  float acc[BN / 2], sum[BN / 2];
  uint32_t ah[16], al[16];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int tm, n0;
    tile_origin<BN>(tile, tiles_m, tiles_n, tiles_n, tm, n0);
#pragma unroll
    for (int v = 0; v < BN / 2; ++v) sum[v] = 0.f;
    for (int t = 0; t < k_tiles; ++t, ++it) {
      const int tap = t % 9;
      const uint32_t hq = it / 9, h = hq % HALOS;
      unsigned char* hi = smem + 2 * h * R::PLANE;
      unsigned char* lo = hi + R::PLANE;
      if (tap == 0) {
        // The slice's halo, split in place: hi over it, lo beside it.
        mbar_wait(halo_full + 8 * h, (hq / HALOS) & 1);
        for (int e = threadIdx.x; e < (int)R::HALO_BYTES / 16; e += THREADS) {
          const uint4 v = reinterpret_cast<const uint4*>(hi)[e];
          uint4 vh, vl;
          tf32x3::split(__uint_as_float(v.x), vh.x, vl.x);
          tf32x3::split(__uint_as_float(v.y), vh.y, vl.y);
          tf32x3::split(__uint_as_float(v.z), vh.z, vl.z);
          tf32x3::split(__uint_as_float(v.w), vh.w, vl.w);
          reinterpret_cast<uint4*>(hi)[e] = vh;
          reinterpret_cast<uint4*>(lo)[e] = vl;
        }
        // Before the next TMA write to the slot (the async proxy); then the
        // two warpgroups' barrier (1: the producer warp takes no part).
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
      }
      const uint32_t s = it % STAGES;
      const uint32_t sb = base + R::B_OFF + s * R::STAGE_BYTES;
      mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
      load_a(hi, lo, g.halo_row(r0, tap), quad, ah, al);
      issue_stage<BN>(acc, ah, al, sb, sb + R::B_BYTES);
      __syncwarp();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ah);
      fence_regs(al);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(bar_empty + 8 * s);
        if (tap == 8) mbar_arrive(halo_empty + 8 * h);
      }
#pragma unroll
      for (int v = 0; v < BN / 2; ++v) sum[v] = __fadd_rn(sum[v], acc[v]);
    }
    const int rows[2] = {g.pixel(tm, r0), g.pixel(tm, r0 + 8)};
    store_tile<BN>(epi, rows, n0, lane, sum);
  }
}

// An f32 tensor map with 128-byte swizzled boxes: `rank` dims (dims[0]
// contiguous), byte strides of dims 1.. , box sizes; zeros past every end.
inline bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                     int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D f32 map over `rows` rows of `cols` floats (contiguous), boxes of
// 32 x box_rows.
inline bool make_map_2d(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                        long long cols, long long rows, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {BK, (cuuint32_t)box_rows};
  return make_map(encode, map, ptr, 2, dims, strides, box);
}

// The card's SM count, with kern's dynamic shared memory set to `bytes`.
template <class Kernel>
int prepare(Kernel kern, size_t bytes, int& sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
  }
  return (int)err;
}

// C = epi(A (M, K) B^T), B given by `bsplit` as split() wrote it for B's
// `rows` rows (gated: `hidden` > 0, rows = 2H), a fresh tensor-core sum
// every SUM_K of K (gemm_kernel); K a multiple of 4, epi.n of 4, every
// pointer 16-byte aligned. Returns a CUDA error code.
template <class Epi, int SUM_K = BK>
int gemm(const float* a, const uint32_t* bsplit, int m, int rows, int k,
         int hidden, const Epi& epi, void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  if (rows <= 0 || k <= 0 || k % 4 || epi.n <= 0 || epi.n % 4 ||
      Epi::GATED != (hidden > 0) || Epi::ROW) {
    return (int)cudaErrorInvalidValue;
  }
  const int npad = split_rows(rows, hidden);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap ta, tb;
  if (!make_map_2d(encode, &ta, a, k, m, BM) ||
      !make_map_2d(encode, &tb, bsplit, k, 2ll * npad, BN)) {
    return (int)cudaErrorInvalidValue;
  }
  int sms = 0;
  const int err = prepare(gemm_kernel<Epi, SUM_K>, SMEM_BYTES, sms);
  if (err != 0) return err;
  const int tiles_n = npad / BN;
  const int tiles = (m + BM - 1) / BM * tiles_n;
  long long group = GROUP_BYTES / ((long long)BN * k * 8);
  if (group < 1) group = 1;
  if (group > tiles_n) group = tiles_n;
  const int grid = tiles < sms ? tiles : sms;
  gemm_kernel<Epi, SUM_K>
      <<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
          ta, tb, m, npad, k, (int)group, epi);
  return (int)cudaGetLastError();
}

// epi on the (B H W, n) f32 sums of the 3x3 conv with zero padding of x
// (B, H, W, C) f32, contiguous, by the weights (n, 9 C), k = (3 dh + dw) C
// + c, given by `wsplit` as split() wrote it; ceil(n / BN) column tiles of
// BN (a ROW epilogue: n = BN = 32). C a multiple of 32, n of 4, both
// pointers 16-byte aligned. Returns a CUDA error code.
template <int BN, class Epi>
int conv3x3(const float* x, const uint32_t* wsplit, int batch, int h, int w,
            int c, int n, const Epi& epi, void* stream) {
  typedef HaloRing<BN> R;
  typedef tf32x3::ConvTiles G;
  if (batch <= 0 || h <= 0 || w <= 0) return (int)cudaSuccess;
  if (c <= 0 || c % BK || n <= 0 || n % 4 || epi.n != n || Epi::GATED ||
      (Epi::ROW && n != BN)) {
    return (int)cudaErrorInvalidValue;
  }
  const int npad = split_rows(n, 0);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  // x as a 4-D map over (C, W, H, B), boxes of a slice's halo.
  const cuuint64_t px = (cuuint64_t)c * 4, row = px * w;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {px, row, row * h};
  const cuuint32_t box[4] = {BK, G::P + 2, G::R + 2, 1};
  CUtensorMap ta, tb;
  if (!make_map(encode, &ta, x, 4, dims, strides, box) ||
      !make_map_2d(encode, &tb, wsplit, 9ll * c, 2ll * npad, BN)) {
    return (int)cudaErrorInvalidValue;
  }
  int sms = 0;
  const int err = prepare(conv_kernel<BN, Epi>, R::SMEM_BYTES, sms);
  if (err != 0) return err;
  const G g{c, h, w, batch};
  const int tiles_n = (n + BN - 1) / BN;
  const int tiles = g.tiles() * tiles_n;
  const int grid = tiles < sms ? tiles : sms;
  conv_kernel<BN, Epi>
      <<<grid, CONV_THREADS, R::SMEM_BYTES, (cudaStream_t)stream>>>(
          ta, tb, g, tiles_n, npad, epi);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// h (M, N) = GELU(sums + b1): fc1's epilogue of rows 8 and 9 at f32, the
// A&S GELU or with TANH the tanh GELU (vrvg::bias_gelu_f32).
template <bool TANH>
struct BiasGelu {
  static constexpr bool GATED = false, ROW = false;
  int n;
  float* c;
  const float* bias;
  __device__ __forceinline__ void store(int row, int col, float v0,
                                        float v1) const {
    const float2 b = ld2(bias + col);
    *reinterpret_cast<float2*>(c + (long long)row * n + col) =
        make_float2(bias_gelu_f32<TANH>(v0, b.x),
                    bias_gelu_f32<TANH>(v1, b.y));
  }
};

// out (M, 3D) = [q * scale | k | v] with [q | k | v] = sums + bias: row 5's
// epilogue at f32 (vrvg::qkv_f32), q's columns those below d. d is even, so
// a pair of columns is all q or none. out is (B, N, 3, H, 64).
struct QkvScale {
  static constexpr bool GATED = false, ROW = false;
  int n;  // 3D
  float* out;
  const float* bias;  // (3D,)
  int d;
  float scale;
  __device__ __forceinline__ void store(int row, int col, float v0,
                                        float v1) const {
    const float2 b = ld2(bias + col);
    const bool is_q = col < d;
    *reinterpret_cast<float2*>(out + (long long)row * n + col) =
        make_float2(qkv_f32(v0, b.x, scale, is_q),
                    qkv_f32(v1, b.y, scale, is_q));
  }
};

// out (M, N) = x + gamma * (sums + bias): row 6's epilogue at f32 (proj +
// LayerScale + residual) and the down products' of rows 8, 9 and 10 at f32
// (vrvg::ls_residual_f32).
struct LayerScaleResidual {
  static constexpr bool GATED = false, ROW = false;
  int n;
  float* out;
  const float* x;
  const float* bias;
  const float* gamma;
  __device__ __forceinline__ void store(int row, int col, float v0,
                                        float v1) const {
    const long long at = (long long)row * n + col;
    const float2 b = ld2(bias + col), g = ld2(gamma + col), r = ld2(x + at);
    *reinterpret_cast<float2*>(out + at) =
        make_float2(ls_residual_f32(v0, b.x, g.x, r.x),
                    ls_residual_f32(v1, b.y, g.y, r.y));
  }
};

// g (M, H) = silu(x1 + b12[:H]) * (x2 + b12[H:]): row 10's gate epilogue
// at f32 (vrvg::swiglu_gate_f32), on the gated operand's sums.
struct SwigluGate {
  static constexpr bool GATED = true, ROW = false;
  int n;  // H
  float* g;
  const float* bias;  // b12, (2H,)
  __device__ __forceinline__ void store(int row, int col, float x10,
                                        float x11, float x20,
                                        float x21) const {
    const float2 b1 = ld2(bias + col), b2 = ld2(bias + n + col);
    *reinterpret_cast<float2*>(g + (long long)row * n + col) =
        make_float2(swiglu_gate_f32(x10, b1.x, x20, b2.x),
                    swiglu_gate_f32(x11, b1.y, x21, b2.y));
  }
};

// C (M, N) = the sums: row 11's folded conv1 at f32 (mid, bias-free), row
// 7's out_conv mix at f32 (xoc), and a conv's sums alone (vrvg_conv3x3_f32).
struct Store {
  static constexpr bool GATED = false, ROW = false;
  int n;
  float* c;
  __device__ __forceinline__ void store(int row, int col, float v0,
                                        float v1) const {
    *reinterpret_cast<float2*>(c + (long long)row * n + col) =
        make_float2(v0, v1);
  }
};

// C (M, N) = the sums + an f32 bias (vrvg::bias_f32): rows 7 and 15's
// conv1 at f32 (c1).
struct BiasStore {
  static constexpr bool GATED = false, ROW = false;
  int n;
  float* c;
  const float* bias;
  __device__ __forceinline__ void store(int row, int col, float v0,
                                        float v1) const {
    const float2 b = ld2(bias + col);
    *reinterpret_cast<float2*>(c + (long long)row * n + col) =
        make_float2(bias_f32(v0, b.x), bias_f32(v1, b.y));
  }
};

// out (pixels, C) = a refinenet1 residual-unit conv's epilogue at f32 on
// its sums (vrvg::rcu_out_f32): + bias, with RELU a ReLU, then NRES
// residuals (pixels, C) added in order; relu(out) into relu_copy unless it
// is null (vrvg::relu_copy_f32). Row 16's four convs at f32.
template <bool RELU, int NRES>
struct RcuEpi {
  static constexpr bool GATED = false, ROW = false;
  int n;  // C
  float* out;
  const float* bias;
  const float* res0;
  const float* res1;
  float* relu_copy;
  __device__ __forceinline__ void store(int row, int col, float v0,
                                        float v1) const {
    const long long at = (long long)row * n + col;
    const float2 b = ld2(bias + col);
    const float2 r0 = NRES > 0 ? ld2(res0 + at) : make_float2(0.f, 0.f);
    const float2 r1 = NRES > 1 ? ld2(res1 + at) : make_float2(0.f, 0.f);
    const float o0 = rcu_out_f32<RELU, NRES>(v0, b.x, r0.x, r1.x);
    const float o1 = rcu_out_f32<RELU, NRES>(v1, b.y, r0.y, r1.y);
    *reinterpret_cast<float2*>(out + at) = make_float2(o0, o1);
    if (relu_copy != nullptr) {
      *reinterpret_cast<float2*>(relu_copy + at) =
          make_float2(relu_copy_f32(o0), relu_copy_f32(o1));
    }
  }
};

// out (pixels,) = depth from a pixel's 32 sums of output_conv2: + b2, ReLU,
// the 1x1 in channel order, + b3, ReLU (vrvg::depth_out_f32): rows 12, 7
// and 15's conv2 at f32.
struct DepthOut {
  static constexpr bool GATED = false, ROW = true;
  int n;  // 32
  float* out;
  const float* b2;
  const float* w3;
  const float* b3;
  __device__ __forceinline__ void store_row(int row,
                                            const float (&v)[32]) const {
    out[row] = depth_out_f32(v, b2, w3, __ldg(b3));
  }
};

}  // namespace tf32x3_gemm
}  // namespace
