// Kernel 1 at f32: softmax attention of the ViT blocks at any head dim but
// 64 for --compute_dtype float32, for Hopper (sm_90a): rows 2 and 17 at the
// head dims of a custom ModelConfig (csrc/attention_f32.cu takes 64).
// Entered through csrc/attention_any.cu's vrvg_attention_any.
//
// attention_any_f32_kernel<..., false> replaces vr_video_generator_tpu/ops/
// attention_pallas.py `oneshot_mha_heads` (row 2) run at f32, and
// attention_any_f32_kernel<..., true> the JAX library flash kernel that
// vr_video_generator_tpu/ops/attention.py `_flash_mha` calls past 4096
// tokens (row 17) at f32, at the head dims it takes: q pre-scaled (row 2)
// or the f32 logits times sm_scale in f32 (row 17), logits, softmax and
// P V in f32, nothing cast; an online softmax over key tiles, divided by l
// once at the end (csrc/attention_f32.cu's order at 64; chip_smoke.py
// holds it against the f64 function).
//
// What bounds it on the H100: the two products, 4 B H N^2 Dh FLOPs, each
// 3xTF32 (csrc/tf32x3.cuh: x = hi + lo in TF32, a b = (a_hi b_lo + a_lo
// b_hi) + a_hi b_hi, to about 2^-21 of |a||b| a term): three TF32 products
// at the card's 495 TFLOP/s are 165 TFLOP/s of f32-accurate product, 0.44
// ms at 12 heads of 32 (B = 8, N = 2443) and 0.89 ms at 6 heads of 128,
// against 60-120 MB of q/k/v/o: bound by operations.
//
// Design: csrc/attention_f32.cu's, at every head dim, the block's shape from
// csrc/attention_any_plan.cuh. csrc/attention_any_pass.cu's split pass
// reads q, k and v (any strides) once and writes Q and K as TF32 hi/lo
// planes of rows of DP = 32 c floats, (B H Npad, DP), and V^T's planes
// (B H DP, Npad), Npad = N rounded up to 128, zeros past N and past Dh
// (so no view needs any alignment), V^T's 8-key groups in
// tf32x3::pv_slot_key's order. One block per (q tile, column block, head,
// batch): g consumer warpgroups per 64-row q group and a producer warp
// (one thread issues the TMA loads, 2-D maps, 128-byte swizzle, 32-float
// boxes; a warp, so that each thread may hold 224 registers). Q stays in
// shared memory where it fits beside two stages, else it streams with K
// in slabs of two chunks (64 dims). S = Q K^T is 3xTF32
// wgmma.m64nBNk8.tf32 with both operands from shared memory, a fresh
// tensor-core sum every 64 dims added in f32 (the tensor core's f32 sums
// truncate, so a sum over Dh = 512's 64 k-steps would drift); the online
// softmax runs on the accumulators (expf, quad shuffles); P is split
// in registers into wgmma's register A fragments; P V is 3xTF32
// wgmma.m64n(32 oc)k8 against V^T, a fresh sum each tile, and O = O alpha
// + P V by FMA. Each consumer owns oc chunks of O's columns (O and P V
// take 32 oc registers); above 128 the q group's two consumers, and past
// 256 a grid axis of column blocks, each compute S themselves. O / l
// leaves by plain stores, rows >= N and columns >= Dh skipped.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phases 12
// and 14; PERF.md, kernel table): row 2 / row 17 at 12 heads of 32 1.84 /
// 1.62 ms (0.47x / 0.43x one f32 scaled_dot_product_attention call), at 6
// of 128 3.09 / 2.81 (0.87x / 0.85x); at 2 heads of 320-512 7.1-10.4 ms,
// 2.0-2.1x f32 SDPA: there Q streams from L2 again every 32-key tile (8
// bytes a head dim at 3xTF32: its 1/16 byte a FLOP outruns L2) and S is
// computed 2.5-2.8 times over (two consumers and two column blocks). The
// FFMA kernel it replaces took 4.1-34.5 ms.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_any.cuh"
#include "attention_any_plan.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

using namespace vrvg;
using attn_any::Plan;

constexpr int RB = attn_any::ROW_BYTES;

struct RowStats {
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
};

// The online softmax of one S tile (64 x BN, f32) on its accumulator
// registers (csrc/attention_f32.cu's softmax_tile at any BN): logits times
// `scale` (SCALED), keys >= n to -inf, the new running max, alpha, l
// rescaled and summed, and P split into TF32 hi and lo. The exponentials
// are expf: with ex2.approx of the logits times log2 e (csrc/attention_f32
// .cu's), row 17 at 4785 keys was up to 4.5e-6 of max |o| off f64, over
// chip_smoke.py's 3.7e-6; with expf 1.3e-6, at 1% more time (NVIDIA H100
// 80GB HBM3, 700 W; Dh = 128, 6 heads, B = 2).
template <bool SCALED, int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2],
                                             uint32_t (&ph)[BN / 2],
                                             uint32_t (&pl)[BN / 2],
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
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(st.m[i], quad_max(mx[i]));
    alpha[i] = expf(__fsub_rn(st.m[i], m_new));
    st.m[i] = m_new;
  }
  // Each row's share of the tile's sum by pairs, then l = l alpha + it. A
  // running sum of every p (~1050 terms a thread at N = 4200) put row 17
  // up to 4.4e-6 of max |o| off f64 (chip_smoke.py's bound: 3.7e-6).
  float sum[2][BN / 8];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float p0 = expf(__fsub_rn(s[4 * j + 2 * i], st.m[i]));
      const float p1 = expf(__fsub_rn(s[4 * j + 2 * i + 1], st.m[i]));
      sum[i][j] = __fadd_rn(p0, p1);
      // p is finite (a NaN logit's shows in l).
      tf32x3::split_finite(p0, ph[4 * j + 2 * i], pl[4 * j + 2 * i]);
      tf32x3::split_finite(p1, ph[4 * j + 2 * i + 1], pl[4 * j + 2 * i + 1]);
    }
  }
#pragma unroll
  for (int w = 1; w < BN / 8; w *= 2) {
#pragma unroll
    for (int j = 0; j + w < BN / 8; j += 2 * w) {
      sum[0][j] = __fadd_rn(sum[0][j], sum[0][j + w]);
      sum[1][j] = __fadd_rn(sum[1][j], sum[1][j + w]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.l[i] = __fadd_rn(__fmul_rn(st.l[i], alpha[i]), sum[i][0]);
  }
}

struct Layout {
  int c, sc, stages, q_bytes, stage_bytes;
  int npad;
  long long bhn;  // rows of a Q or K plane: B H Npad
  long long bhd;  // rows of a V^T plane: B H DP
};

// A fresh 3xTF32 sum of S over `np` (1 or 2) chunks: (Q_hi K_lo + Q_lo
// K_hi) over their k-steps, then Q_hi K_hi. qa/ka: the hi planes' first
// chunk; `q_plane`/`k_plane`: bytes to the lo planes.
template <int BN>
__device__ __forceinline__ void s_part(float (&d)[BN / 2], uint32_t qa,
                                       uint32_t q_plane, uint32_t ka,
                                       uint32_t k_plane, uint32_t q_step,
                                       uint32_t k_step, int np) {
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (j < np) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t q = qa + j * q_step + 32 * kk;
        const uint32_t k = ka + j * k_step + 32 * kk;
        wgmma_ss_tf32<BN>(d, sw128_desc(q, 16), sw128_desc(k + k_plane, 16),
                          (j | kk) != 0);
        wgmma_ss_tf32<BN>(d, sw128_desc(q + q_plane, 16), sw128_desc(k, 16),
                          1);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (j < np) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_tf32<BN>(d, sw128_desc(qa + j * q_step + 32 * kk, 16),
                          sw128_desc(ka + j * k_step + 32 * kk, 16), 1);
      }
    }
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(d);
}

// P V over k-steps [K0, K1) of 8 keys, a fresh sum: (P_hi V_lo + P_lo V_hi)
// then P_hi V_hi. P's accumulator pairs (keys 8 kk + 2 quad, + 1) go in as
// the A fragment's slots quad and quad + 4, where V^T's 8-key group holds
// those keys (tf32x3::pv_slot_key). va: this consumer's rows of V^T_hi;
// its V^T_lo lies v_plane bytes on.
template <int OC, int VROWS, int K0, int K1, int NP>
__device__ __forceinline__ void pv_chain(float (&d)[OC * 16],
                                         const uint32_t (&ph)[NP],
                                         const uint32_t (&pl)[NP],
                                         uint32_t va, uint32_t v_plane) {
#pragma unroll
  for (int kk = K0; kk < K1; ++kk) {
    const uint32_t off = va + (kk >> 2) * VROWS * RB + (kk & 3) * 32;
    wgmma_tf32<32 * OC>(d, ph[4 * kk], ph[4 * kk + 2], ph[4 * kk + 1],
                        ph[4 * kk + 3], sw128_desc(off + v_plane, 16),
                        kk > K0);
    wgmma_tf32<32 * OC>(d, pl[4 * kk], pl[4 * kk + 2], pl[4 * kk + 1],
                        pl[4 * kk + 3], sw128_desc(off, 16), 1);
  }
#pragma unroll
  for (int kk = K0; kk < K1; ++kk) {
    const uint32_t off = va + (kk >> 2) * VROWS * RB + (kk & 3) * 32;
    wgmma_tf32<32 * OC>(d, ph[4 * kk], ph[4 * kk + 2], ph[4 * kk + 1],
                        ph[4 * kk + 3], sw128_desc(off, 16), 1);
  }
}

// The TMA loads of ring item `item` into its slot: key tile t = item / (ns
// + 1), and in it slab item % (ns + 1) of S (K's chunks, and Q's where Q
// streams; hi and lo planes) or, after the last slab, V^T's rows of column
// block cbi for the tile's keys.
template <int QG, int G, int OC, int BN, bool RES>
__device__ __forceinline__ void load_item(const CUtensorMap* tq,
                                          const CUtensorMap* tk,
                                          const CUtensorMap* tv,
                                          const Layout& lay, uint32_t ring,
                                          uint32_t bar_full, int item, int ns,
                                          long long bh, int q0, int cbi) {
  constexpr int QROWS = 64 * QG;
  constexpr int VROWS = 32 * G * OC;
  constexpr int KC = BN / 32;
  const int slot = item % lay.stages;
  const uint32_t st = ring + slot * lay.stage_bytes;
  const uint32_t full = bar_full + 8 * slot;
  const int t = item / (ns + 1), si = item % (ns + 1);
  if (si < ns) {
    const int qc = RES ? lay.c : lay.sc;
    const uint32_t k_off = RES ? 0u : (uint32_t)(2 * lay.sc * QROWS * RB);
    const int q_row = (int)(bh * lay.npad) + q0;
    const int k_row = (int)(bh * lay.npad) + t * BN;
    const int ch0 = si * lay.sc;
    const int nch = min(lay.sc, lay.c - ch0);
    mbar_expect_tx(full, 2 * nch * (BN + (RES ? 0 : QROWS)) * RB);
    for (int p = 0; p < 2; ++p) {
      for (int j = 0; j < nch; ++j) {
        if (!RES) {
          tma_load_2d(st + (p * qc + j) * QROWS * RB, tq, 32 * (ch0 + j),
                      (int)(p * lay.bhn) + q_row, full);
        }
        tma_load_2d(st + k_off + (p * qc + j) * BN * RB, tk, 32 * (ch0 + j),
                    (int)(p * lay.bhn) + k_row, full);
      }
    }
  } else {
    const int v_row = (int)(bh * lay.c * 32) + cbi * VROWS;
    mbar_expect_tx(full, 2 * KC * VROWS * RB);
    for (int p = 0; p < 2; ++p) {
      for (int kc = 0; kc < KC; ++kc) {
        tma_load_2d(st + (p * KC + kc) * VROWS * RB, tv, t * BN + 32 * kc,
                    (int)(p * lay.bhd) + v_row, full);
      }
    }
  }
}

// One block of QG G consumer warpgroups per (q tile x column block, head,
// batch), warpgroup w holding q group w / G and column group w % G, and a
// producer warp whose first thread keeps the ring full (168 registers a
// thread: at oc = 4 O, its P V sum and S spill up to 0.4 KB, yet a
// consumer's thread 0 issuing the loads under its products, which leaves
// 255, was 1.25-1.55x slower). tq/tk: 2-D maps over the split Q and K, (DP,
// 2 B H Npad), boxes of 32 x rows; tv: over V^T, (Npad, 2 B H DP), boxes of
// 32 keys x 32 g oc rows.
template <int QG, int G, int OC, int BN, bool RES, bool SCALED>
__global__ void __launch_bounds__(128 * QG * G + 32, 1)
    attention_any_f32_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             float* __restrict__ o, int n, int d, int cb,
                             const Layout lay, long long o_sb,
                             long long o_sn, float scale) {
  constexpr int CONSUMERS = QG * G;
  constexpr int QROWS = 64 * QG;
  constexpr int VROWS = 32 * G * OC;  // V^T rows (head dims) of a block
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ring = base + lay.q_bytes;
  const uint32_t bar_full = ring + lay.stages * lay.stage_bytes;
  const uint32_t bar_empty = bar_full + 8 * lay.stages;
  const uint32_t bar_q = bar_empty + 8 * lay.stages;

  const int qt = blockIdx.x / cb, cbi = blockIdx.x % cb;
  const int q0 = qt * QROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * gridDim.y + h;
  const int n_tiles = (n + BN - 1) / BN;
  const int ns = (lay.c + lay.sc - 1) / lay.sc;
  const int items = n_tiles * (ns + 1);
  // Chunks of a plane in Q's region or a stage of S; Q's slab (streamed)
  // first, then K's.
  const int qc = RES ? lay.c : lay.sc;
  const uint32_t k_off = RES ? 0u : (uint32_t)(2 * lay.sc * QROWS * RB);

  if (threadIdx.x == 0) {
    for (int s = 0; s < lay.stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * CONSUMERS);  // one per consumer warp
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 128 * CONSUMERS) {
    // The producer warp: one thread loads Q, then every item once its
    // stage is released.
    if (threadIdx.x == 128 * CONSUMERS) {
      if (RES) {
        mbar_expect_tx(bar_q, lay.q_bytes);
        for (int p = 0; p < 2; ++p) {
          for (int ch = 0; ch < lay.c; ++ch) {
            tma_load_2d(base + (p * qc + ch) * QROWS * RB, &tq, 32 * ch,
                        (int)(p * lay.bhn + bh * lay.npad) + q0, bar_q);
          }
        }
      }
      for (int i = 0; i < items; ++i) {
        mbar_wait(bar_empty + 8 * (i % lay.stages),
                  ((i / lay.stages) & 1) ^ 1);
        load_item<QG, G, OC, BN, RES>(&tq, &tk, &tv, lay, ring, bar_full, i,
                                      ns, bh, q0, cbi);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int qg = wg / G, g = wg % G;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int quad = lane & 3;

  float acc[OC * 16], pv[OC * 16];
#pragma unroll
  for (int i = 0; i < OC * 16; ++i) acc[i] = 0.f;
  float s[BN / 2], sp[BN / 2];
  uint32_t ph[BN / 2], pl[BN / 2];
  RowStats st;
  float alpha[2];

  if (RES) mbar_wait(bar_q, 0);
  int item = 0;
  for (int t = 0; t < n_tiles; ++t) {
    for (int si = 0; si < ns; ++si, ++item) {
      const int slot = item % lay.stages;
      const uint32_t stg = ring + slot * lay.stage_bytes;
      mbar_wait(bar_full + 8 * slot, (item / lay.stages) & 1);
      const int nch = min(lay.sc, lay.c - si * lay.sc);
      const uint32_t q_base = (RES ? base : stg) + qg * 64 * RB;
      const uint32_t k_base = stg + k_off;
      // Fresh sums of two chunks (64 dims), added in f32.
      for (int j0 = 0; j0 < nch; j0 += 2) {
        const int np = min(2, nch - j0);
        const uint32_t qa = q_base + j0 * QROWS * RB;
        const uint32_t ka = k_base + j0 * BN * RB;
        if (si == 0 && j0 == 0) {
          s_part<BN>(s, qa, qc * QROWS * RB, ka, qc * BN * RB, QROWS * RB,
                     BN * RB, np);
        } else {
          s_part<BN>(sp, qa, qc * QROWS * RB, ka, qc * BN * RB, QROWS * RB,
                     BN * RB, np);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) s[i] = __fadd_rn(s[i], sp[i]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * slot);
    }
    softmax_tile<SCALED, BN>(s, ph, pl, st, alpha, n - t * BN, quad, scale);
    // P V over the tile's BN / 8 k-steps of 8 keys, a fresh sum.
    const int slot = item % lay.stages;
    const uint32_t va = ring + slot * lay.stage_bytes + g * OC * 32 * RB;
    constexpr uint32_t V_PLANE = BN / 32 * VROWS * RB;
    mbar_wait(bar_full + 8 * slot, (item / lay.stages) & 1);
    fence_regs(pv);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
    pv_chain<OC, VROWS, 0, BN / 8>(pv, ph, pl, va, V_PLANE);
    wgmma_commit();
    wgmma_wait();
    fence_regs(pv);
    fence_regs(ph);
    fence_regs(pl);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * slot);
    ++item;
#pragma unroll
    for (int j = 0; j < OC * 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[4 * j + e] = fmaf(acc[4 * j + e], alpha[e >> 1], pv[4 * j + e]);
      }
    }
  }

  // o / l, rows < n and columns < d.
  const float l[2] = {quad_sum(st.l[0]), quad_sum(st.l[1])};
  const int r0 = q0 + qg * 64 + warp * 16 + (lane >> 2);
  const int col0 = (cbi * G + g) * OC * 32 + 2 * quad;
  const bool pairs = ((d | o_sn | o_sb) & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= n) continue;
    float* orow = o + b * o_sb + row * o_sn + (long long)h * d;
#pragma unroll
    for (int j = 0; j < OC * 4; ++j) {
      const int col = col0 + 8 * j;
      const float x0 = __fdiv_rn(acc[4 * j + 2 * i], l[i]);
      const float x1 = __fdiv_rn(acc[4 * j + 2 * i + 1], l[i]);
      if (pairs && col + 1 < d) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
      } else {
        if (col < d) orow[col] = x0;
        if (col + 1 < d) orow[col + 1] = x1;
      }
    }
  }
}

// A 2-D f32 map over `rows` rows of `cols` floats (contiguous), boxes of
// 32 x box_rows (one 128-byte swizzled chunk).
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
              long long cols, long long rows, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int QG, int G, int OC, int BN, bool RES, bool SCALED>
int launch(const Plan& pl, const float* ws, void* o, int batch, int n,
           int npad, int heads, int d, long long o_sb, long long o_sn,
           float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const int dp = pl.dp();
  const long long bhn = (long long)batch * heads * npad;
  const long long bhd = (long long)batch * heads * dp;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, ws, dp, 2 * bhn, 64 * QG) ||
      !make_map(encode, &tk, ws + 2 * bhn * dp, dp, 2 * bhn, BN) ||
      !make_map(encode, &tv, ws + 4 * bhn * dp, npad, 2 * bhd,
                32 * G * OC)) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout lay{pl.c, pl.sc, pl.stages, pl.q_bytes(), pl.stage_bytes(),
                   npad, bhn, bhd};
  const int smem = pl.smem_bytes();
  auto kernel = attention_any_f32_kernel<QG, G, OC, BN, RES, SCALED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + 64 * QG - 1) / (64 * QG) * pl.cb, heads, batch);
  kernel<<<grid, pl.threads(), smem, stream>>>(
      tq, tk, tv, static_cast<float*>(o), n, d, pl.cb, lay, o_sb, o_sn,
      scale);
  return (int)cudaGetLastError();
}

template <bool SCALED>
int dispatch(const Plan& pl, const float* ws, void* o, int batch, int n,
             int npad, int heads, int d, long long o_sb, long long o_sn,
             float scale, cudaStream_t stream) {
#define VRVG_ANY(QG, G, OC, BN, RES)                                        \
  if (pl.qg == QG && pl.g == G && pl.oc == OC && pl.bn == BN &&             \
      pl.resident() == RES) {                                               \
    return launch<QG, G, OC, BN, RES, SCALED>(pl, ws, o, batch, n, npad,    \
                                              heads, d, o_sb, o_sn, scale,  \
                                              stream);                      \
  }
  VRVG_ANY(2, 1, 1, 64, true)
  VRVG_ANY(2, 1, 2, 64, true)
  VRVG_ANY(2, 1, 3, 32, true)
  VRVG_ANY(2, 1, 4, 32, true)
  VRVG_ANY(1, 2, 3, 32, true)
  VRVG_ANY(1, 2, 4, 32, false)
#undef VRVG_ANY
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Rows 2 and 17 at f32 (vrvg_attention_any's f32 branch): `scratch` 6 * B *
// H * Npad * DP floats (Npad = N rounded up to 128, DP = the plan's padded
// head dim), 16-byte aligned.
extern "C" int vrvg_attention_any_f32(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int n, int heads, int d, long long q_sb,
                                      long long q_sn, long long k_sb,
                                      long long k_sn, long long v_sb,
                                      long long v_sn, long long o_sb,
                                      long long o_sn, float scale,
                                      int scaled, void* scratch,
                                      void* stream) {
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const Plan pl = attn_any::plan(d, 1);
  const int npad = (n + 127) / 128 * 128;
  int err = vrvg_attention_any_split(q, k, v, scratch, batch, n, npad, heads,
                                     d, pl.dp(), q_sb, q_sn, k_sb, k_sn, v_sb,
                                     v_sn, stream);
  if (err != 0) return err;
  const float* ws = static_cast<const float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return scaled ? dispatch<true>(pl, ws, o, batch, n, npad, heads, d, o_sb,
                                 o_sn, scale, st)
                : dispatch<false>(pl, ws, o, batch, n, npad, heads, d, o_sb,
                                  o_sn, scale, st);
}
