// An f32-accurate GEMM core on the tensor cores for Hopper (sm_90a), by
// 3xTF32: C (M x N) = epilogue(A (M x K) B^T), A f32 row-major (K-major), B
// an nn.Linear weight (N, K) given as its TF32 split (split_kernel), sums
// f32, C f32. Rows 8, 9 and 10 at f32 (csrc/mlp_f32.cu, csrc/swiglu_f32.cu)
// run their products on it; the rest of the f32 rows stay on the SIMT core
// of csrc/sgemm.cuh for now.
//
// Why 3xTF32: wgmma takes no f32 operands, and TF32 keeps 10 mantissa bits.
// Each operand x is the sum of two TF32 values hi + lo (csrc/tf32x3.cuh,
// |x - hi - lo| <= 2^-22 |x|), and a b = (a_lo b_hi + a_hi b_lo) + a_hi b_hi
// to about 2^-21 |a||b| a term: three TF32 products at the card's 495
// TFLOP/s make 165 TFLOP/s of f32-accurate product, against 67 TFLOP/s on
// the CUDA cores (the SIMT core reached 38-44). At vitg-518's row 10 (M =
// 19544, D = 1536, H = 4096) the two products are 737.7 GFLOP: 4.47 ms at
// 165 TFLOP/s, against 0.25 ms for its f32 bytes: bound by operations.
//
// Design: a persistent kernel, one block of two warpgroups on each SM,
// walking 128 x 128 tiles of C.
//   - The weights are split once, not at every call: split_kernel writes
//     B's hi plane then its lo plane, (2, Npad, K) TF32 bit patterns, Npad
//     = N rounded up to 128 with zero rows; for row 10's gate, w12's rows
//     in tf32x3::gated_row's order (x1 and x2 of 64 hidden columns a
//     128-row tile). The caller keeps the result with the weight
//     (ops/mlp.tf32x3_weight).
//   - Thread 0 keeps a ring of STAGES stages full by TMA (2-D maps,
//     128-byte swizzle, f32 boxes of 32 columns): a stage is A's 128 x 32
//     tile and B_hi's and B_lo's 128 x 32 tiles, 48 KB, behind full/empty
//     mbarriers, running ahead across tiles. It refills a slot while its
//     own warpgroup's products of the next stage run. There is no producer
//     warp: ptxas sizes registers by whole warpgroups, so a 288-thread
//     block gets the 168 of 384 threads, and spilled.
//   - Each warpgroup owns 64 rows of the tile. At each stage it
//     reads its A fragment from shared memory (wgmma's .tf32 register
//     layout; the 128-byte swizzle keeps the 32 lanes on 32 banks), splits
//     it in registers into hi and lo (tf32x3::split), and issues twelve
//     wgmma.m64n128k8.tf32, B from shared memory: lo.hi and hi.lo over the
//     stage's four k-steps, then hi.hi, the small terms first, into a fresh
//     accumulator. It waits for them, releases the stage, and adds the
//     accumulator into its running f32 sums by FADD. The tensor core's own
//     f32 accumulation truncates, and an attention output summed on it over
//     75 tiles drifted to 1.8e-5-3.4e-5 of |o| (csrc/attention_f32.cu), so
//     no sum on the core runs longer than one stage: 32 of K, 12 products.
//     The two warpgroups share the SM's tensor cores, so one's wait,
//     release, FADD and A split run under the other's products.
//   - After the tile's last stage the warpgroups apply the epilogue to
//     their running sums from registers and store C as f32 pairs; the ring
//     already holds the next tile's first stages.
//   - Tiles run in groups of column tiles whose hi/lo B panel fits in
//     GROUP_BYTES of L2, each group walked row band by row band: the
//     blocks in flight share that panel and A's row bands. (w12's hi and
//     lo take 100 MB, twice the 50 MB L2, so a band-by-band order would
//     read all of B from device memory once per band.)
// Registers: a thread holds 64 accumulators, 64 running sums and the A
// fragment's 16 hi and 16 lo values: 194-197 registers, no spills (ptxas,
// sm_90a), of the 255 that 256 threads leave.
//
// Register layout of a wgmma f32 accumulator (64 x 128) in a warpgroup:
// thread (warp w, lane l) holds rows r0 = 16 w + l / 4 and r0 + 8; value
// 4 j + 2 i + c sits at row r0 + 8 i, column 8 j + 2 (l % 4) + c. Columns
// c and c + 64 are in one thread (j and j + 8): a gated epilogue takes x1
// from j < 8 and x2 from j + 8.
//
// An epilogue is a struct with
//   static constexpr bool GATED;
//   int n;  // C's columns (gated: H, the hidden columns of g)
// and, not gated,
//   __device__ void store(int row, int col, float v0, float v1) const;
// given the f32 sums of C[row, col : col + 2] (row < M, col < N, col even);
// gated,
//   __device__ void store(int row, int col, float x1_0, float x1_1,
//                         float x2_0, float x2_1) const;
// given the sums of x1 and x2 of hidden columns col, col + 1 (col < H). It
// writes C itself, with its arithmetic from csrc/epilogue_f32.cuh.

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
constexpr int BN = 128;  // C columns a tile
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

// Rows of the split B operand: N rounded up to BN; gated (row 10's w12 with
// H hidden columns), 128 ceil(H / 64).
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

// Tile `tile` of the walk -> its first row and column: groups of `group`
// column tiles (the last one narrower), each walked row band by row band.
__device__ __forceinline__ void tile_origin(int tile, int tiles_m,
                                            int tiles_n, int group, int& m0,
                                            int& n0) {
  const int per = group * tiles_m;
  const int g = tile / per, r = tile - g * per;
  const int width = min(group, tiles_n - g * group);
  m0 = r / width * BM;
  n0 = (g * group + r % width) * BN;
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
  int m0, n0;
  tile_origin(blockIdx.x + (int)(q / k_tiles) * gridDim.x, tiles_m, tiles_n,
              group, m0, n0);
  const int k0 = (int)(q % k_tiles) * BK;
  const uint32_t s = q % STAGES, sb = base + s * STAGE_BYTES;
  mbar_expect_tx(bar_full + 8 * s, STAGE_BYTES);
  tma_load_2d(sb, ta, k0, m0, bar_full + 8 * s);
  tma_load_2d(sb + A_BYTES, tb, k0, n0, bar_full + 8 * s);
  tma_load_2d(sb + A_BYTES + B_BYTES, tb, k0, npad + n0, bar_full + 8 * s);
}

template <class Epi>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb, int m, int npad,
                int k, int group, const Epi epi) {
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
  const int swz = r0 & 7;  // (r0 + 8) & 7 too
  uint32_t it = 0;         // stages consumed, over all tiles
  float acc[64], sum[64];
  // A's fragment of a stage: k-step kk's registers 4 kk + 2 c + i hold
  // A[r0 + 8 i][8 kk + quad + 4 c], in the order wgmma takes them.
  uint32_t ah[16], al[16];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    tile_origin(tile, tiles_m, tiles_n, group, m0, n0);
#pragma unroll
    for (int v = 0; v < 64; ++v) sum[v] = 0.f;
    for (int t = 0; t < k_tiles; ++t, ++it) {
      const uint32_t s = it % STAGES;
      const uint32_t sb = base + s * STAGE_BYTES;
      mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
      // Row r0 of A's tile: 32 floats in eight 16-byte units, unit u at
      // u ^ (row & 7); k-slot 8 kk + quad + 4 c is unit 2 kk + c.
      const float* arow =
          reinterpret_cast<const float*>(smem + s * STAGE_BYTES + r0 * 128);
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
      fence_regs(acc);
      fence_regs(ah);
      fence_regs(al);
      wgmma_fence();
      // A k-step of 8 is 32 bytes along B's 128-byte swizzled rows.
      const uint64_t dh = sw128_desc(sb + A_BYTES, 16);
      const uint64_t dl = sw128_desc(sb + A_BYTES + B_BYTES, 16);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n128k8_tf32(acc, al[4 * kk], al[4 * kk + 1], al[4 * kk + 2],
                             al[4 * kk + 3], dh + 2 * kk, kk > 0);
        wgmma_m64n128k8_tf32(acc, ah[4 * kk], ah[4 * kk + 1], ah[4 * kk + 2],
                             ah[4 * kk + 3], dl + 2 * kk, 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n128k8_tf32(acc, ah[4 * kk], ah[4 * kk + 1], ah[4 * kk + 2],
                             ah[4 * kk + 3], dh + 2 * kk, 1);
      }
      wgmma_commit();
      // Under the products: refill the slot stage it - 1 used with stage
      // it - 1 + STAGES, once both warpgroups have released it.
      if (producer && it > 0 && it - 1 + STAGES < stages) {
        mbar_wait(bar_empty + 8 * ((it - 1) % STAGES),
                  ((it - 1) / STAGES) & 1);
        load_stage(&ta, &tb, base, bar_full, it - 1 + STAGES, k_tiles,
                   tiles_m, tiles_n, group, npad);
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
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + r0 + 8 * i;
      if (row >= m) continue;
      if constexpr (Epi::GATED) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = n0 / 2 + 8 * j + 2 * quad;
          if (col < epi.n) {
            epi.store(row, col, sum[4 * j + 2 * i], sum[4 * j + 2 * i + 1],
                      sum[4 * (j + 8) + 2 * i], sum[4 * (j + 8) + 2 * i + 1]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = n0 + 8 * j + 2 * quad;
          if (col < epi.n) {
            epi.store(row, col, sum[4 * j + 2 * i], sum[4 * j + 2 * i + 1]);
          }
        }
      }
    }
  }
}

// A 2-D f32 map over `rows` rows of `cols` floats (contiguous), boxes of
// 32 x 128 (a 128-byte swizzled tile), zeros past either end.
inline bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                     long long cols, long long rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {BK, BM};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// C = epi(A (M, K) B^T), B given by `bsplit` as split() wrote it for B's
// `rows` rows (gated: `hidden` > 0, rows = 2H); K a multiple of 4, epi.n
// of 4, every pointer 16-byte aligned. Returns a CUDA error code.
template <class Epi>
int gemm(const float* a, const uint32_t* bsplit, int m, int rows, int k,
         int hidden, const Epi& epi, void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  if (rows <= 0 || k <= 0 || k % 4 || epi.n <= 0 || epi.n % 4 ||
      Epi::GATED != (hidden > 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const int npad = split_rows(rows, hidden);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap ta, tb;
  if (!make_map(encode, &ta, a, k, m) ||
      !make_map(encode, &tb, bsplit, k, 2ll * npad)) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(gemm_kernel<Epi>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
  }
  if (err != cudaSuccess) return (int)err;
  const int tiles_n = npad / BN;
  const int tiles = (m + BM - 1) / BM * tiles_n;
  long long group = GROUP_BYTES / ((long long)BN * k * 8);
  if (group < 1) group = 1;
  if (group > tiles_n) group = tiles_n;
  const int grid = tiles < sms ? tiles : sms;
  gemm_kernel<Epi><<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      ta, tb, m, npad, k, (int)group, epi);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// h (M, N) = GELU(sums + b1): fc1's epilogue of rows 8 and 9 at f32, the
// A&S GELU or with TANH the tanh GELU (vrvg::bias_gelu_f32).
template <bool TANH>
struct BiasGelu {
  static constexpr bool GATED = false;
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

// out (M, N) = x + gamma * (sums + bias): the down products' epilogue of
// rows 8, 9 and 10 at f32 (vrvg::ls_residual_f32).
struct LayerScaleResidual {
  static constexpr bool GATED = false;
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
  static constexpr bool GATED = true;
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

}  // namespace tf32x3_gemm
}  // namespace
