// Kernel 1 at bf16: softmax attention of the ViT blocks at any head dim but
// 64, for Hopper (sm_90a): rows 2 and 17 at the head dims of a custom
// ModelConfig (csrc/attention.cu takes 64). The f32 half is
// csrc/attention_any_f32.cu; this file's entry point dispatches to it.
//
// attention_any_kernel<..., false> replaces vr_video_generator_tpu/ops/
// attention_pallas.py `oneshot_mha_heads` (kernel body `_kernel`, up to 4096
// tokens), which takes any head dim: q arrives pre-scaled, the logits and
// the softmax statistics are f32, the probabilities are cast to bf16 before
// P V, P V accumulates in f32, and the output is o / l cast to bf16.
// attention_any_kernel<..., true> replaces the JAX library flash kernel that
// vr_video_generator_tpu/ops/attention.py `_flash_mha` calls past 4096
// tokens (jax.experimental.pallas.ops.tpu.flash_attention), at the head
// dims it takes (any with one K block; with several, up to 128 and
// multiples of 128 above, its MIN_BLOCK_SIZE: another raises
// NotImplementedError there and is refused here): q unscaled, the f32
// logits multiplied by sm_scale in f32. Keys >= N are masked; rows >= N and
// columns >= Dh are never stored. Both rows walk the keys in tiles with an
// online softmax (a running max, the output rescaled by exp(m_old - m_new)
// a tile, divided by l once at the end), as csrc/attention.cu does at 64:
// the library's 512-key blocks and the one-shot softmax differ from it only
// in f32 rounding and in which running max the bf16 probabilities are taken
// against, which chip_smoke.py bounds against the plain versions
// (ops/attention.py).
//
// What bounds it on the H100: the two products, 4 B H N^2 Dh FLOPs (73 GFLOP
// at 12 heads of 32, B = 8, N = 2443; 147 at 6 heads of 128) against 40-60
// MB of q/k/v/o: 0.074 and 0.148 ms at the 989 TFLOP/s bf16 peak, if the
// logits never reach device memory. At small head dims the exponentials
// bound it instead: one a logit, 16 a clock an SM, 573M logits at 12 heads
// of 32 take ~0.15 ms, twice the products; so, as at 64, one warpgroup's
// softmax has to run under another's products.
//
// Design: csrc/attention.cu's, with the head dim cut into 64-wide chunks
// (128-byte rows of the 128-byte swizzle) and the shape of the block taken
// from csrc/attention_any_plan.cuh by head dim. The head dim is zero-padded
// to DP = 64 c: TMA reads a 64-wide box of each chunk over a map whose
// innermost dim is Dh, so columns >= Dh arrive as zeros (at Dh = 32 half of
// the products are on zeros; the exponentials bound it there anyway). Where
// TMA cannot read the views (Dh * 2 bytes or a token or batch stride not a
// multiple of 16 bytes), csrc/attention_any_pass.cu's pad pass first writes
// q, k and v with rows of round_up(Dh, 8) into the wrapper's scratch. One
// block per (q tile of qg 64-row groups, column block, head, batch) holds g
// consumer warpgroups per q group; one thread keeps TMA loads in flight
// behind full/empty mbarriers: a producer warp's where the consumers fit
// 168 registers a thread, else consumer thread 0, under its warpgroup's
// products (ptxas caps a thread's registers by the block's warps: 255 at
// 8, 168 at 9 to 12; setmaxnreg does not raise them). Each consumer holds
// O for its 64 rows and its oc chunks of columns in registers, computes S =
// Q K^T over the whole head dim (wgmma.m64nBNk16, both operands K-major in
// shared memory; Q resident, or streamed with K in slabs of 4 chunks where
// it does not fit), runs the online softmax on the accumulator registers
// (row max and sum over the quad, by shuffles; ex2.approx of the logits
// times log2 e), packs P to bf16 as wgmma's register A operand, and adds P V
// (wgmma.m64n(64 oc)k16, V read through the transpose bit) for its columns.
// Above 256 the g = 2 consumers of a q group each take 192 or 256 columns
// and each computes S itself (1.5x the useful products at 384 and 512; past
// 512 a grid axis of column blocks, each recomputing S). The ring carries K
// tiles (with Q slabs) and V tiles as separate stages. O / l leaves by
// plain stores, rows >= N and columns >= Dh skipped, so any output head dim
// is stored.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phases 12
// and 14; PERF.md, kernel table): row 2 / row 17 at 12 heads of 32 0.62 /
// 0.65 ms (1.5x / 1.7x one scaled_dot_product_attention call), at 6 of 128
// 0.57 / 0.51 (1.8x / 1.6x), at 2 heads of 320-512 0.60-1.24 (0.49-0.64x);
// the FFMA kernel it replaces took 4.3-35 ms. The producer warp was the
// faster where O is at most 3 chunks (up to 1.4x at 384); at 4 it spilled
// 1.2-2.6 KB a thread and ran 3.6x slower than consumer thread 0's loads.

#include <cuda_bf16.h>
#include <math.h>

#include "attention_any.cuh"
#include "attention_any_plan.cuh"
#include "hopper.cuh"

namespace {

using namespace vrvg;
using attn_any::Plan;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int RB = attn_any::ROW_BYTES;
// Row 17 past this many tokens is the library's blocked kernel, which takes
// head dims up to 128 and multiples of 128 (ops/attention.flash_takes).
constexpr int FLASH_ONE_BLOCK = 4096;

struct RowStats {
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
};

// The online softmax of one S tile (64 x BN) on its accumulator registers:
// logits times `scale` (SCALED), keys >= n (`valid` = n - the tile's first
// key) to -inf, the new running max, alpha = exp(m_old - m_new) for O, l
// rescaled and summed, and P as bf16 pairs in wgmma's A-fragment order
// (csrc/attention.cu's softmax_tile at any BN). Accumulator layout: thread
// (warp w, lane l) holds rows r0 = 16 w + l / 4 and r0 + 8; value 4 j + 2 i
// + c sits at row r0 + 8 i, column 8 j + 2 (l % 4) + c.
template <bool SCALED, int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2],
                                             uint32_t (&p)[BN / 4],
                                             RowStats& st, float (&alpha)[2],
                                             int valid, int quad,
                                             float scale) {
  if (SCALED) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = __fmul_rn(s[i], scale);
  }
  if (valid < BN) {
    const int lim = valid - 2 * quad;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (8 * j + c >= lim) {
          s[4 * j + c] = -INFINITY;
          s[4 * j + 2 + c] = -INFINITY;
        }
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float mln[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // Every tile holds a real key, so the new max is finite; alpha is 0 at
    // the first tile (m = -inf).
    const float m_new = fmaxf(st.m[i], quad_max(mx[i]));
    mln[i] = m_new * LOG2E;
    alpha[i] = ex2(fmaf(st.m[i], LOG2E, -mln[i]));
    st.m[i] = m_new;
    st.l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float p00 = ex2(fmaf(s[4 * j], LOG2E, -mln[0]));
    const float p01 = ex2(fmaf(s[4 * j + 1], LOG2E, -mln[0]));
    const float p10 = ex2(fmaf(s[4 * j + 2], LOG2E, -mln[1]));
    const float p11 = ex2(fmaf(s[4 * j + 3], LOG2E, -mln[1]));
    st.l[0] += p00 + p01;
    st.l[1] += p10 + p11;
    p[2 * j] = pack_bf16(p00, p01);  // bf16 P, as on the TPU
    p[2 * j + 1] = pack_bf16(p10, p11);
  }
}

// The shared-memory layout a launch runs with (Plan's, by value).
struct Layout {
  int c;            // head-dim chunks
  int sc;           // chunks a stage of S (c: Q resident)
  int stages;
  int q_bytes;      // resident Q
  int stage_bytes;
};

// The TMA loads of ring item `item` into its slot: key tile t = item / (ns
// + 1), and in it slab item % (ns + 1) of S (K's chunks, Q's too where Q
// streams) or, after the last slab, V's chunks of column block cbi.
template <int QG, int G, int OC, int BN, bool RES>
__device__ __forceinline__ void load_item(const CUtensorMap* tq,
                                          const CUtensorMap* tk,
                                          const CUtensorMap* tv,
                                          const Layout& lay, uint32_t ring,
                                          uint32_t bar_full, int item, int ns,
                                          int q0, int h, int b, int cbi) {
  constexpr int QROWS = 64 * QG;
  const int slot = item % lay.stages;
  const uint32_t st = ring + slot * lay.stage_bytes;
  const uint32_t full = bar_full + 8 * slot;
  const int t = item / (ns + 1), si = item % (ns + 1);
  if (si < ns) {
    const int ch0 = si * lay.sc;
    const int nch = min(lay.sc, lay.c - ch0);
    const uint32_t k_off = RES ? 0u : (uint32_t)(lay.sc * QROWS * RB);
    mbar_expect_tx(full, nch * (BN + (RES ? 0 : QROWS)) * RB);
    for (int j = 0; j < nch; ++j) {
      if (!RES) {
        tma_load_4d(st + j * QROWS * RB, tq, 64 * (ch0 + j), h, q0, b, full);
      }
      tma_load_4d(st + k_off + j * BN * RB, tk, 64 * (ch0 + j), h, t * BN, b,
                  full);
    }
  } else {
    const int v0 = cbi * G * OC;
    const int nv = min(G * OC, lay.c - v0);
    mbar_expect_tx(full, nv * BN * RB);
    for (int j = 0; j < nv; ++j) {
      tma_load_4d(st + j * BN * RB, tv, 64 * (v0 + j), h, t * BN, b, full);
    }
  }
}

// One block of QG G consumer warpgroups per (q tile x column block, head,
// batch): warpgroup w holds q group w / G and column group w % G. The ring
// is kept full by a producer warp after them (PW), or else by thread 0,
// which fills the first stages and, under each item's products, loads the
// items the ring has room for (so that with two consumers each thread may
// hold 255 registers). KC: the most chunks a stage of S holds (the chunk
// loop unrolled, so that no move of the accumulators splits a wgmma
// pipeline stage). q/k/v: 4-D maps over (Dh, H, N, B), 64 x 1 x rows x 1
// boxes; o: (B, N, H, d) bf16 with the given batch and token strides,
// stored by plain stores.
template <int QG, int G, int OC, int BN, bool RES, int KC, bool PW,
          bool SCALED>
__global__ void __launch_bounds__(128 * QG * G + (PW ? 32 : 0), 1)
    attention_any_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         __nv_bfloat16* __restrict__ o, int n, int d, int cb,
                         const Layout lay, long long o_sb, long long o_sn,
                         float scale) {
  constexpr int CONSUMERS = QG * G;
  constexpr int QROWS = 64 * QG;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ring = base + lay.q_bytes;
  const uint32_t bar_full = ring + lay.stages * lay.stage_bytes;  // + 8 s
  const uint32_t bar_empty = bar_full + 8 * lay.stages;
  const uint32_t bar_q = bar_empty + 8 * lay.stages;

  const int qt = blockIdx.x / cb, cbi = blockIdx.x % cb;
  const int q0 = qt * QROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (n + BN - 1) / BN;
  const int ns = (lay.c + lay.sc - 1) / lay.sc;
  const int items = n_tiles * (ns + 1);
  // In a stage of S: Q's slab (streamed), then K's.
  const uint32_t k_off = RES ? 0u : (uint32_t)(lay.sc * QROWS * RB);
  // The thread that issues the TMA loads: the producer warp's first (PW),
  // else consumer thread 0.
  const bool producer = threadIdx.x == (PW ? 128 * CONSUMERS : 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < lay.stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * CONSUMERS);  // one per consumer warp
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (producer) {
    if (RES) {
      mbar_expect_tx(bar_q, lay.q_bytes);
      for (int ch = 0; ch < lay.c; ++ch) {
        tma_load_4d(base + ch * QROWS * RB, &tq, 64 * ch, h, q0, b, bar_q);
      }
    }
    // PW: every item, each once its stage is released; else the first
    // stages, and refill() the rest.
    for (int i = 0; i < (PW ? items : min(lay.stages, items)); ++i) {
      if (PW) {
        mbar_wait(bar_empty + 8 * (i % lay.stages),
                  ((i / lay.stages) & 1) ^ 1);
      }
      load_item<QG, G, OC, BN, RES>(&tq, &tk, &tv, lay, ring, bar_full, i, ns,
                                    q0, h, b, cbi);
    }
  }
  if (PW && threadIdx.x >= 128 * CONSUMERS) return;

  const int wg = threadIdx.x / 128;
  const int qg = wg / G, g = wg % G;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int quad = lane & 3;
  // Without a producer warp, thread 0's next item to load: under item i's
  // products it loads every item up to i + stages - lag, waiting for each
  // stage to be released by all consumers. The lag (half the ring, at
  // least 1) lets one consumer run up to lag items ahead of another without
  // waiting, so that one's softmax can run under the other's products.
  int next = min(lay.stages, items);
  const int ahead = lay.stages - max(1, lay.stages / 2);
  auto refill = [&](int i) {
    if (!PW && producer) {
      for (; next < items && next <= i + ahead; ++next) {
        mbar_wait(bar_empty + 8 * (next % lay.stages),
                  ((next - lay.stages) / lay.stages) & 1);
        load_item<QG, G, OC, BN, RES>(&tq, &tk, &tv, lay, ring, bar_full,
                                      next, ns, q0, h, b, cbi);
      }
    }
    __syncwarp();
  };

  float acc[OC * 32];
#pragma unroll
  for (int i = 0; i < OC * 32; ++i) acc[i] = 0.f;
  float s[BN / 2];
  uint32_t p[BN / 4];
  RowStats st;
  float alpha[2];

  if (RES) mbar_wait(bar_q, 0);
  int item = 0;
  for (int t = 0; t < n_tiles; ++t) {
    // S = Q K^T over the head dim's chunks, four k-steps of 16 a chunk (32
    // bytes along a 128-byte swizzled row), one sum.
    for (int si = 0; si < ns; ++si, ++item) {
      const int slot = item % lay.stages;
      const uint32_t stg = ring + slot * lay.stage_bytes;
      mbar_wait(bar_full + 8 * slot, (item / lay.stages) & 1);
      const int nch = min(lay.sc, lay.c - si * lay.sc);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        if (j < nch) {
          const uint32_t qa =
              (RES ? base + j * QROWS * RB : stg + j * QROWS * RB) +
              qg * 64 * RB;
          const uint32_t ka = stg + k_off + j * BN * RB;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_m64k16<BN>(s, sw128_desc(qa + 32 * kk, 16),
                             sw128_desc(ka + 32 * kk, 16), (si | j | kk) != 0);
          }
        }
      }
      wgmma_commit();
      refill(item);
      wgmma_wait();
      fence_regs(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * slot);
    }
    softmax_tile<SCALED, BN>(s, p, st, alpha, n - t * BN, quad, scale);
#pragma unroll
    for (int j = 0; j < OC * 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    // O += P V: BN / 16 k-steps of 16 keys (2048 bytes of each chunk); this
    // consumer's chunks are BN * 128 bytes apart (the leading byte offset
    // of the MN-major operand).
    const int slot = item % lay.stages;
    const uint32_t va = ring + slot * lay.stage_bytes + g * OC * BN * RB;
    mbar_wait(bar_full + 8 * slot, (item / lay.stages) & 1);
    fence_regs(acc);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BN / 16; ++k) {
      wgmma_pv<64 * OC>(acc, p[4 * k], p[4 * k + 1], p[4 * k + 2],
                        p[4 * k + 3], sw128_desc(va + 2048 * k, BN * RB));
    }
    wgmma_commit();
    refill(item);
    wgmma_wait();
    fence_regs(acc);
    fence_regs(p);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * slot);
    ++item;
  }

  // o / l to bf16, rows < n and columns < d.
  const float l[2] = {quad_sum(st.l[0]), quad_sum(st.l[1])};
  const int r0 = q0 + qg * 64 + warp * 16 + (lane >> 2);
  const int col0 = (cbi * G + g) * OC * 64 + 2 * quad;
  // Pairs as one 4-byte store where every offset is even.
  const bool pairs = ((d | o_sn | o_sb) & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= n) continue;
    __nv_bfloat16* orow = o + b * o_sb + row * o_sn + (long long)h * d;
#pragma unroll
    for (int j = 0; j < OC * 8; ++j) {
      const int col = col0 + 8 * j;
      const float x0 = acc[4 * j + 2 * i] / l[i];
      const float x1 = acc[4 * j + 2 * i + 1] / l[i];
      if (pairs && col + 1 < d) {
        *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(x0, x1);
      } else {
        if (col < d) orow[col] = __float2bfloat16_rn(x0);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// (B, N, H, dm) bf16 with the (H, dm) pair contiguous as a 4-D map over
// (dm, H, N, B), boxes of (64, 1, rows, 1), 128-byte swizzle, zero fill:
// chunk ch's box at column 64 ch reads columns >= dm as zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
              int batch, int n, int heads, int dm, long long sb, long long sn,
              int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)dm, (cuuint64_t)heads,
                              (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)dm * 2, (cuuint64_t)sn * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Views {
  const void *q, *k, *v;
  int dm;  // the maps' innermost dim: Dh, or the pad pass's round_up(Dh, 8)
  long long q_sb, q_sn, k_sb, k_sn, v_sb, v_sn;
};

template <int QG, int G, int OC, int BN, bool RES, int KC, bool PW,
          bool SCALED>
int launch(const Plan& pl, const Views& in, void* o, int batch, int n,
           int heads, int d, long long o_sb, long long o_sn, float scale,
           cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, in.q, batch, n, heads, in.dm, in.q_sb, in.q_sn,
                64 * QG) ||
      !make_map(encode, &tk, in.k, batch, n, heads, in.dm, in.k_sb, in.k_sn,
                BN) ||
      !make_map(encode, &tv, in.v, batch, n, heads, in.dm, in.v_sb, in.v_sn,
                BN)) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout lay{pl.c, pl.sc, pl.stages, pl.q_bytes(), pl.stage_bytes()};
  const int smem = pl.smem_bytes();
  auto kernel = attention_any_kernel<QG, G, OC, BN, RES, KC, PW, SCALED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + 64 * QG - 1) / (64 * QG) * pl.cb, heads, batch);
  kernel<<<grid, pl.threads(), smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), n, d, pl.cb, lay, o_sb,
      o_sn, scale);
  return (int)cudaGetLastError();
}

// The instantiation of plan `pl` (attn_any::plan at bf16).
template <bool SCALED>
int dispatch(const Plan& pl, const Views& in, void* o, int batch, int n,
             int heads, int d, long long o_sb, long long o_sn, float scale,
             cudaStream_t stream) {
#define VRVG_ANY(QG, G, OC, BN, RES, KC, PW)                               \
  if (pl.qg == QG && pl.g == G && pl.oc == OC && pl.bn == BN &&             \
      pl.resident() == RES && pl.sc <= KC && pl.pw == PW) {                 \
    return launch<QG, G, OC, BN, RES, KC, PW, SCALED>(                      \
        pl, in, o, batch, n, heads, d, o_sb, o_sn, scale, stream);          \
  }
  VRVG_ANY(3, 1, 1, 128, true, 1, false)
  VRVG_ANY(2, 1, 2, 128, true, 2, true)
  VRVG_ANY(2, 1, 3, 64, true, 3, true)
  VRVG_ANY(2, 1, 4, 64, true, 4, false)
  VRVG_ANY(1, 2, 3, 64, true, 6, true)
  VRVG_ANY(1, 2, 4, 64, true, 9, false)
  VRVG_ANY(1, 2, 4, 64, false, 4, false)
#undef VRVG_ANY
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p, long long sb, long long sn) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 &&
         sn % 8 == 0;
}

}  // namespace

// f32 (csrc/attention_any_f32.cu): the same arguments, `scratch` the split
// pass's 6 * B * H * Npad * DP floats (ops/attention.py f32_scratch_numel).
extern "C" int vrvg_attention_any_f32(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int n, int heads, int d, long long q_sb,
                                      long long q_sn, long long k_sb,
                                      long long k_sn, long long v_sb,
                                      long long v_sn, long long o_sb,
                                      long long o_sn, float scale,
                                      int scaled, void* scratch,
                                      void* stream);

// q/k/v/o: (B, N, H, Dh) with the (H, Dh) pair contiguous, bf16 (f32 == 0)
// or f32; the batch and token strides in elements; Dh >= 1. scaled == 0:
// row 2, q pre-scaled, `scale` ignored; scaled != 0: row 17, the f32 logits
// times `scale`, past FLASH_ONE_BLOCK tokens Dh <= 128 or a multiple of 128
// (the library kernel's rule). `scratch`: at bf16, where TMA cannot read
// q, k and v as they are (Dh % 8, a stride % 8 or an address % 16 not 0),
// 3 * B * N * H * round_up(Dh, 8) bf16 for the pad pass, else unused; at
// f32 the split pass's. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what no kernel computes (writing nothing).
extern "C" int vrvg_attention_any(const void* q, const void* k, const void* v,
                                  void* o, int batch, int n, int heads, int d,
                                  long long q_sb, long long q_sn,
                                  long long k_sb, long long k_sn,
                                  long long v_sb, long long v_sn,
                                  long long o_sb, long long o_sn, float scale,
                                  int scaled, int f32, void* scratch,
                                  void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0) return (int)cudaSuccess;
  if (d < 1 ||
      (scaled && n > FLASH_ONE_BLOCK && d > 128 && d % 128 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (f32) {
    return vrvg_attention_any_f32(q, k, v, o, batch, n, heads, d, q_sb, q_sn,
                                  k_sb, k_sn, v_sb, v_sn, o_sb, o_sn, scale,
                                  scaled, scratch, stream);
  }
  Views in{q, k, v, d, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn};
  if (d % 8 != 0 || !aligned16(q, q_sb, q_sn) || !aligned16(k, k_sb, k_sn) ||
      !aligned16(v, v_sb, v_sn)) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const int dm = (d + 7) / 8 * 8;
    const long long part = (long long)batch * n * heads * dm;
    const long long sn = (long long)heads * dm, sb = n * sn;
    int err = vrvg_attention_any_pad(q, k, v, scratch, batch, n, heads, d, dm,
                                     q_sb, q_sn, k_sb, k_sn, v_sb, v_sn,
                                     stream);
    if (err != 0) return err;
    const __nv_bfloat16* ws = static_cast<const __nv_bfloat16*>(scratch);
    in = Views{ws, ws + part, ws + 2 * part, dm, sb, sn, sb, sn, sb, sn};
  }
  const Plan pl = attn_any::plan(d, 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return scaled ? dispatch<true>(pl, in, o, batch, n, heads, d, o_sb, o_sn,
                                 scale, st)
                : dispatch<false>(pl, in, o, batch, n, heads, d, o_sb, o_sn,
                                  scale, st);
}
