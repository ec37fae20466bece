// Softmax attention of the DINOv2 blocks at f32, for Hopper (sm_90a): the
// f32 variant of csrc/attention.cu for --compute_dtype float32, one kernel
// built twice, and the pass that splits K and V for it.
//
// attention_f32_kernel<false> replaces vr_video_generator_tpu/ops/
// attention_pallas.py `oneshot_mha_heads` (kernel body `_kernel`, row 2, up
// to 4096 tokens) run at f32: q arrives pre-scaled, logits, softmax and the
// PV product are f32, the output is o / l.
// attention_f32_kernel<true> replaces the JAX library flash kernel that
// vr_video_generator_tpu/ops/attention.py `_flash_mha` calls past 4096
// tokens (row 17) at f32: q is unscaled and the f32 logits are multiplied
// by sm_scale in f32 before the softmax.
// Both walk the keys in tiles of 64 with an online softmax (a running max
// m, the sum l and the output rescaled by exp(m_old - m_new) at each tile,
// divided by l once at the end). At f32 that is the one-shot softmax and the
// library's 512-key blocks to f32 rounding: nothing is cast between the
// products (the bf16 kernels round P to bf16 before PV, which both TPU
// functions do at bf16 and neither does at f32). chip_smoke.py holds each
// instantiation against its plain version (ops/attention.py).
//
// What bounds it on the H100: the two products are 4 * B*H*N^2*64 FLOPs,
// 73.3 GFLOP at vits (B = 8, H = 6, N = 2443) and 187.6 at vitl-728 (B = 2,
// H = 16, N = 4785). No tensor core takes f32 operands, and TF32 keeps 10
// mantissa bits, so each product is 3xTF32 (csrc/tf32x3.cuh): every
// operand x is split into TF32 values hi + lo, and S = (Q_hi K_lo + Q_lo
// K_hi) + Q_hi K_hi, P V = (P_hi V_lo + P_lo V_hi) + P_hi V_hi, the three
// products of each sum in one wgmma accumulator, small terms first, to
// about 2^-21 of |a||b| a term. Three TF32 products at the card's 495
// TFLOP/s are 165 TFLOP/s of f32-accurate product (against 67 outside the
// tensor cores): 0.444 and 1.137 ms, against 60-80 MB of q/k/v/o: bound by
// operations.
//
// Design. split_kv_kernel reads k and v (strided views into the qkv
// output) once and writes, into the wrapper's scratch, K_hi and K_lo as
// (B, H, Npad, 64) and V^T_hi and V^T_lo as (B, H, 64, Npad), Npad = N
// rounded up to 64, keys >= N as zeros: wgmma takes .tf32 operands from
// shared memory K-major only, and PV needs V^T, keys contiguous. Each
// 8-key group of V^T is stored in tf32x3::pv_slot_key's order, so that the
// S accumulator's registers, split, are wgmma's register A fragment of P
// as they lie (no shuffle). attention_f32_kernel runs one block of two
// warpgroups per (128-row q tile, head, batch), each owning 64 query rows.
// Thread 0 issues the TMA loads (2-D maps, 128-byte swizzle, one box a
// 32-column half of a tile) of 64-key K and V^T hi/lo tiles (64 KB a
// stage) into a ring of three stages behind full/empty mbarriers,
// refilling a stage while its warpgroup's S products run; there is no
// producer warpgroup, so each thread may hold 255 registers (Q_hi and Q_lo
// as wgmma's register A fragments, read from device memory and split once:
// 64; S, P V and O: 96; P_hi and P_lo: 64). A tile is 24
// wgmma.m64n64k8.tf32 for S (8 k-steps of 8 dims x three products), the
// online softmax on the f32 accumulator registers (row max and sum over the
// four lanes that share a row, by shuffles; the exponentials ex2.approx of
// the logits times log2(e), which moves p by a few 1e-7 and took the
// kernel from 0.89 to 0.74 ms at vits against expf), P split in registers
// (tf32x3::split_finite: 0.73 to 0.69 ms against the split that keeps
// NaN, 0.73 with PTX cvt.rna.tf32.f32), and 24 more for its P V, a fresh
// sum each tile: O = O * alpha + P V by FMA. The tensor core's f32
// accumulation truncates, so an O summed on it over every tile drifted
// with N (mean error 1.8e-5 of |o| at vits, 3.4e-5 at vitl-728, against
// the plain version; the bound is 1e-5). O is divided by l once and stored
// as f32 pairs; rows >= N are not stored. Keys >= N (the zero rows of the
// ragged last tile) get -inf logits. The two warpgroups share the SM's
// tensor cores without any ordering, so one's softmax runs under the
// other's products.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, kernel table):
// kernel-only 0.76 ms at vits (0.07 of it the split pass), 2.82 at
// vitg-518's 24 heads, 1.72 at vitl-728 B = 2: 96-109 TFLOP/s counting
// the f32 FLOPs once, 0.31-0.33x one f32 scaled_dot_product_attention
// call (the SIMT kernel it replaces: 23-25 TFLOP/s); at most 3.7e-6 of
// max |o| from the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

using namespace vrvg;

constexpr int DH = 64;           // head dim: two 128-byte halves of f32
constexpr int CONSUMERS = 2;     // warpgroups, 64 query rows each
constexpr int BM = 64 * CONSUMERS;  // query rows per block
constexpr int BN = 64;           // keys per K/V^T tile
constexpr int STAGES = 3;        // K/V^T ring depth
constexpr int THREADS = 128 * CONSUMERS;
// One 64-row, 32-column f32 half tile: 64 rows of 128 bytes, one TMA box
// and eight 1024-byte swizzle atoms.
constexpr uint32_t HALF_BYTES = 64 * 128;
// A stage: K [hi, lo][dims 0-31, 32-63], then V^T [hi, lo][keys 0-31,
// 32-63], each a half tile.
constexpr uint32_t VT_OFF = 4 * HALF_BYTES;
constexpr uint32_t STAGE_BYTES = 8 * HALF_BYTES;  // 64 KB
constexpr uint32_t BAR_OFF = STAGES * STAGE_BYTES;
// full[STAGES], empty[STAGES]; +1024 to align the tiles to the swizzle
// atom.
constexpr size_t SMEM_BYTES = BAR_OFF + 8 * 2 * STAGES + 1024;
constexpr int SPLIT_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

// 2^x (MUFU.EX2, relative error about 2^-22; subnormal results flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// One (64-key, H, B) tile of K and V to their TF32 halves in `ws`: K_hi,
// K_lo rows of 64 dims, then V^T_hi, V^T_lo rows of Npad keys (each part
// `part` = B*H*Npad*64 floats), keys >= n as zeros. V^T goes through
// shared memory, its 8-key groups in pv_slot_key's order.
__global__ void __launch_bounds__(SPLIT_THREADS)
    split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                    float* __restrict__ ws, int n, int npad, int heads,
                    long long k_sb, long long k_sn, long long v_sb,
                    long long v_sn, long long part) {
  __shared__ float vs[BN][DH + 1];
  const int key0 = blockIdx.x * BN, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * heads + h;
  float* kh = ws + (bh * npad + key0) * DH;
  for (int e = threadIdx.x; e < BN * DH / 4; e += SPLIT_THREADS) {
    const int key = e / (DH / 4), d = e % (DH / 4) * 4;
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
    if (key0 + key < n) {
      kv = *reinterpret_cast<const float4*>(k + b * k_sb +
                                            (key0 + key) * k_sn + h * DH + d);
      vv = *reinterpret_cast<const float4*>(v + b * v_sb +
                                            (key0 + key) * v_sn + h * DH + d);
    }
    uint4 hi, lo;
    tf32x3::split(kv.x, hi.x, lo.x);
    tf32x3::split(kv.y, hi.y, lo.y);
    tf32x3::split(kv.z, hi.z, lo.z);
    tf32x3::split(kv.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(kh + key * DH + d) = hi;
    *reinterpret_cast<uint4*>(kh + part + key * DH + d) = lo;
    vs[key][d] = vv.x, vs[key][d + 1] = vv.y;
    vs[key][d + 2] = vv.z, vs[key][d + 3] = vv.w;
  }
  __syncthreads();
  float* vth = ws + 2 * part + bh * DH * npad + key0;
  for (int e = threadIdx.x; e < DH * BN / 4; e += SPLIT_THREADS) {
    const int d = e / (BN / 4), s0 = e % (BN / 4) * 4;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int slot = s0 + c;
      tf32x3::split(vs[(slot & ~7) + tf32x3::pv_slot_key(slot & 7)][d],
                    hi[c], lo[c]);
    }
    *reinterpret_cast<uint4*>(vth + d * npad + s0) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(vth + part + d * npad + s0) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// Running softmax statistics of a thread's two rows (r0 and r0 + 8): the
// max m and this thread's share of the sum l.
struct RowStats {
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
};

// The online softmax of one S tile on its accumulator registers: logits
// times `scale` (SCALED), keys >= n (`valid` = n - the tile's first key)
// to -inf, the new running max, alpha = exp(m_old - m_new) for O, l
// rescaled and summed, and P split into TF32 hi and lo in place of S.
// Register layout of a wgmma f32 accumulator (64 x 64) in a warpgroup:
// thread (warp w, lane l) holds rows r0 = 16 w + l / 4 and r0 + 8; value
// 4 j + 2 i + c sits at row r0 + 8 i, column 8 j + 2 (l % 4) + c.
template <bool SCALED>
__device__ __forceinline__ void softmax_tile(float (&s)[32],
                                             uint32_t (&ph)[32],
                                             uint32_t (&pl)[32], RowStats& st,
                                             float (&alpha)[2], int valid,
                                             int quad, float scale) {
  if (SCALED) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = __fmul_rn(s[i], scale);
  }
  if (valid < BN) {
    const int lim = valid - 2 * quad;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (8 * j + c >= lim) {
          s[4 * j + c] = -INFINITY;
          s[4 * j + 2 + c] = -INFINITY;
        }
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY}, mln[2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // Every tile holds a real key, so the new max is finite; alpha is 0 at
    // the first tile (m = -inf).
    const float m_new = fmaxf(st.m[i], quad_max(mx[i]));
    mln[i] = m_new * LOG2E;
    alpha[i] = ex2(fmaf(st.m[i], LOG2E, -mln[i]));
    st.m[i] = m_new;
    st.l[i] = __fmul_rn(st.l[i], alpha[i]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const float p = ex2(fmaf(s[4 * j + e], LOG2E, -mln[i]));
      st.l[i] = __fadd_rn(st.l[i], p);
      // p is finite (a NaN logit's shows in l).
      tf32x3::split_finite(p, ph[4 * j + e], pl[4 * j + e]);
    }
  }
}

// The TMA loads of key tile t (K and V^T, hi and lo, both 32-column
// halves: eight boxes, one stage) into `stage`, completing on `full`.
__device__ __forceinline__ void load_tile(const CUtensorMap* tk,
                                          const CUtensorMap* tv,
                                          uint32_t stage, uint32_t full,
                                          int t, int k_row0, int k_rows,
                                          int v_row0, int v_rows) {
  mbar_expect_tx(full, STAGE_BYTES);
#pragma unroll
  for (int part = 0; part < 2; ++part) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t off = (2 * part + half) * HALF_BYTES;
      tma_load_2d(stage + off, tk, 32 * half,
                  part * k_rows + k_row0 + t * BN, full);
      tma_load_2d(stage + VT_OFF + off, tv, t * BN + 32 * half,
                  part * v_rows + v_row0, full);
    }
  }
}

// q/o (B, N, H, 64) f32 with the (H, 64) pair contiguous; batch and token
// strides in elements. tk: K_hi rows then K_lo rows, (64, 2 B H Npad); tv:
// V^T_hi rows then V^T_lo rows, (Npad, 2 B H 64); both f32 boxes of 32 x
// 64 in the 128-byte swizzle.
template <bool SCALED>
__global__ void __launch_bounds__(THREADS, 1)
    attention_f32_kernel(const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const float* __restrict__ q, float* __restrict__ o,
                         int n, int npad, int heads, long long q_sb,
                         long long q_sn, long long o_sb, long long o_sn,
                         float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar_full = base + BAR_OFF;  // + 8 s
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (n + BN - 1) / BN;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int quad = lane & 3;
  // Thread 0 keeps the ring full: this head's first rows of K_hi and V^T_hi
  // and the rows of each part.
  const bool producer = threadIdx.x == 0;
  const int k_row0 = (b * heads + h) * npad, k_rows = gridDim.z * heads * npad;
  const int v_row0 = (b * heads + h) * DH, v_rows = gridDim.z * heads * DH;

  if (producer) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * CONSUMERS);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int t = 0; t < STAGES && t < n_tiles; ++t) {
      load_tile(&tk, &tv, base + t * STAGE_BYTES, bar_full + 8 * t, t, k_row0,
                k_rows, v_row0, v_rows);
    }
  }
  __syncthreads();

  // This thread's rows r0 and r0 + 8 of the q tile.
  const int r0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
  // Q_hi, Q_lo as wgmma's register A fragments: k-step kk's four are
  // (r0, 8 kk + quad), (r0 + 8, ..), (r0, 8 kk + quad + 4), (r0 + 8, ..).
  // Rows >= n read row n - 1 and are never stored.
  uint32_t qh[32], ql[32];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = min(r0 + 8 * i, n - 1);
    const float* qp = q + b * q_sb + row * q_sn + h * DH;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int a = 4 * kk + 2 * c + i;
        tf32x3::split(qp[8 * kk + quad + 4 * c], qh[a], ql[a]);
      }
    }
  }

  // O across tiles in f32 by FMA: each tile's P V is its own wgmma sum (24
  // products), so the tensor core's f32 accumulation never runs longer
  // than one tile.
  float acc_o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_o[i] = 0.f;
  float acc_s[32], acc_pv[32];
  uint32_t ph[32], pl[32];
  RowStats st;
  float alpha[2];

  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t % STAGES;
    mbar_wait(bar_full + 8 * cur, (t / STAGES) & 1);
    const uint32_t stage = base + cur * STAGE_BYTES;
    // S = (Q_hi K_lo + Q_lo K_hi) + Q_hi K_hi over 8 k-steps of 8 dims
    // (32 bytes along a 128-byte swizzled row; dims 32-63 in the second
    // half tile), the small terms first.
    fence_regs(acc_s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = (kk >> 2) * HALF_BYTES + (kk & 3) * 32;
      wgmma_m64n64k8_tf32(acc_s, qh[4 * kk], qh[4 * kk + 1], qh[4 * kk + 2],
                          qh[4 * kk + 3],
                          sw128_desc(stage + 2 * HALF_BYTES + off, 16),
                          kk > 0);
      wgmma_m64n64k8_tf32(acc_s, ql[4 * kk], ql[4 * kk + 1], ql[4 * kk + 2],
                          ql[4 * kk + 3], sw128_desc(stage + off, 16), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = (kk >> 2) * HALF_BYTES + (kk & 3) * 32;
      wgmma_m64n64k8_tf32(acc_s, qh[4 * kk], qh[4 * kk + 1], qh[4 * kk + 2],
                          qh[4 * kk + 3], sw128_desc(stage + off, 16), 1);
    }
    wgmma_commit();
    // Under the products: refill the stage tile t - 1 used with tile
    // t + STAGES - 1, once both warpgroups have released it.
    if (producer && t > 0 && t + STAGES - 1 < n_tiles) {
      const int s = (t - 1) % STAGES;
      mbar_wait(bar_empty + 8 * s, ((t - 1) / STAGES) & 1);
      load_tile(&tk, &tv, base + s * STAGE_BYTES, bar_full + 8 * s,
                t + STAGES - 1, k_row0, k_rows, v_row0, v_rows);
    }
    __syncwarp();
    wgmma_wait();
    fence_regs(acc_s);
    softmax_tile<SCALED>(acc_s, ph, pl, st, alpha, n - t * BN, quad, scale);
    // P V = (P_hi V_lo + P_lo V_hi) + P_hi V_hi over 8 k-steps of 8 keys.
    // P's accumulator pairs (keys 8 kk + 2 quad, + 1; rows r0, r0 + 8) go
    // in as the A fragment's slots quad and quad + 4, where V^T's 8-key
    // group holds those keys (tf32x3::pv_slot_key).
    fence_regs(acc_pv);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = VT_OFF + (kk >> 2) * HALF_BYTES + (kk & 3) * 32;
      wgmma_m64n64k8_tf32(acc_pv, ph[4 * kk], ph[4 * kk + 2], ph[4 * kk + 1],
                          ph[4 * kk + 3],
                          sw128_desc(stage + 2 * HALF_BYTES + off, 16),
                          kk > 0);
      wgmma_m64n64k8_tf32(acc_pv, pl[4 * kk], pl[4 * kk + 2], pl[4 * kk + 1],
                          pl[4 * kk + 3], sw128_desc(stage + off, 16), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = VT_OFF + (kk >> 2) * HALF_BYTES + (kk & 3) * 32;
      wgmma_m64n64k8_tf32(acc_pv, ph[4 * kk], ph[4 * kk + 2], ph[4 * kk + 1],
                          ph[4 * kk + 3], sw128_desc(stage + off, 16), 1);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc_pv);
    fence_regs(ph);
    fence_regs(pl);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * cur);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_o[4 * j + e] = fmaf(acc_o[4 * j + e], alpha[e >> 1],
                                acc_pv[4 * j + e]);
      }
    }
  }

  // o / l, f32 pairs straight to device memory; rows >= n are not stored.
  const float l[2] = {quad_sum(st.l[0]), quad_sum(st.l[1])};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row < n) {
      float* op = o + b * o_sb + row * o_sn + h * DH + 2 * quad;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(op + 8 * j) =
            make_float2(__fdiv_rn(acc_o[4 * j + 2 * i], l[i]),
                        __fdiv_rn(acc_o[4 * j + 2 * i + 1], l[i]));
      }
    }
  }
}

// A 2-D f32 map over `rows` rows of `cols` floats (contiguous), boxes of
// 32 x 64 (one 128-byte swizzled half tile).
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
              long long cols, long long rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {32, 64};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool SCALED>
int run(const void* q, const void* k, const void* v, void* o, int batch,
        int n, int heads, long long q_sb, long long q_sn, long long k_sb,
        long long k_sn, long long v_sb, long long v_sn, long long o_sb,
        long long o_sn, float scale, void* scratch, void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0) return (int)cudaSuccess;
  const int npad = (n + BN - 1) / BN * BN;
  const long long part = (long long)batch * heads * npad * DH;
  float* ws = static_cast<float*>(scratch);
  split_kv_kernel<<<dim3(npad / BN, heads, batch), SPLIT_THREADS, 0,
                    (cudaStream_t)stream>>>(
      (const float*)k, (const float*)v, ws, n, npad, heads, k_sb, k_sn, v_sb,
      v_sn, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap tk, tv;
  if (!make_map(encode, &tk, ws, DH, 2 * part / DH) ||
      !make_map(encode, &tv, ws + 2 * part, npad, 2 * part / npad)) {
    return (int)cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(attention_f32_kernel<SCALED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + BM - 1) / BM, heads, batch);
  attention_f32_kernel<SCALED><<<grid, THREADS, SMEM_BYTES,
                                 (cudaStream_t)stream>>>(
      tk, tv, (const float*)q, (float*)o, n, npad, heads, q_sb, q_sn, o_sb,
      o_sn, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/o: f32 (B, N, H, 64) with the (H, 64) pair contiguous and 16-byte
// aligned rows; the batch and token strides are given in elements.
// `scratch`: 4 * B * H * Npad * 64 floats (Npad = N rounded up to 64) for
// the split K and V^T, 16-byte aligned. Returns cudaGetLastError().
// vrvg_attention_f32 takes q pre-scaled and ignores `scale` (row 2);
// vrvg_flash_attention_f32 multiplies the f32 logits by `scale` (row 17).
extern "C" int vrvg_attention_f32(const void* q, const void* k,
                                  const void* v, void* o, int batch, int n,
                                  int heads, long long q_sb, long long q_sn,
                                  long long k_sb, long long k_sn,
                                  long long v_sb, long long v_sn,
                                  long long o_sb, long long o_sn, float scale,
                                  void* scratch, void* stream) {
  return run<false>(q, k, v, o, batch, n, heads, q_sb, q_sn, k_sb, k_sn, v_sb,
                    v_sn, o_sb, o_sn, scale, scratch, stream);
}

extern "C" int vrvg_flash_attention_f32(const void* q, const void* k,
                                        const void* v, void* o, int batch,
                                        int n, int heads, long long q_sb,
                                        long long q_sn, long long k_sb,
                                        long long k_sn, long long v_sb,
                                        long long v_sn, long long o_sb,
                                        long long o_sn, float scale,
                                        void* scratch, void* stream) {
  return run<true>(q, k, v, o, batch, n, heads, q_sb, q_sn, k_sb, k_sn, v_sb,
                   v_sn, o_sb, o_sn, scale, scratch, stream);
}
