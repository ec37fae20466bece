// Softmax attention of the DINOv2 blocks, for Hopper (sm_90a): one streaming
// kernel, built twice.
//
// attention_kernel<false> replaces vr_video_generator_tpu/ops/
// attention_pallas.py `oneshot_mha_heads` (kernel body `_kernel`, up to 4096
// tokens). Same arithmetic contract: q arrives pre-scaled in bf16, logits and
// softmax statistics are f32, the probabilities are cast to bf16 before the
// PV product, PV accumulates in f32, and the output is o / l cast to bf16.
//
// attention_kernel<true> replaces the JAX library flash kernel that
// vr_video_generator_tpu/ops/attention.py `_flash_mha` calls past 4096 tokens
// (jax.experimental.pallas.ops.tpu.flash_attention,
// `_flash_attention_kernel_single_batch`): q is unscaled and the f32 logits
// are multiplied by sm_scale in f32 before the softmax. The library walks K
// in 512-key blocks and renormalises the output after each; this kernel walks
// 64-key tiles and divides once at the end. Both are exact online softmaxes
// in f32; they differ only in f32 rounding and in which running max the bf16
// probabilities are taken against, which chip_smoke.py bounds against the
// plain version (ops/attention.flash_attention_plain, the library's order).
// At vitl-728 (B = 2, H = 16, N = 4785) the two GEMMs are 188 GFLOP against
// ~40 MB of q/k/v/o: compute-bound, as row 2.
//
// What bounds it on the H100: at 1080p/vits (B=8, H=6, N=2443, Dh=64) the
// two GEMMs are 2 * 2 * 8*6*2443^2*64 = 73 GFLOP per call, while q/k/v/o
// are ~60 MB, so the kernel is compute-bound (~74 us at the 989 TFLOP/s
// bf16 peak) if the logits never reach device memory (the plain version
// writes and re-reads ~1.1 GB of f32 logits). The TPU kernel held a whole
// (512, N) f32 logits row block in VMEM; a Hopper block has at most 227 KB
// of shared memory, so this kernel streams K/V instead: online softmax over
// 64-key tiles, with the running max / sum in registers, so nothing but
// q/k/v/o touches device memory.
//
// Design: one block of 4 warps per (64-row q tile, head, batch) -> 39 x 6 x 8
// = 1872 blocks. Each warp owns 16 query rows. QK^T and PV run on the tensor
// cores through nvcuda::wmma (bf16 in, f32 accumulate). Tokens >= N are
// zero-filled on load and their logits masked to -inf, so the caller pads
// nothing. q/k/v are read with a token stride, so k and v can be views into
// the fused qkv projection output. Simple first: wgmma with TMA-fed,
// pipelined tiles is the faster form.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int DH = 64;              // head dim
constexpr int TQ = 64;              // query rows per block
constexpr int TK = 64;              // keys per K/V tile
constexpr int WARPS = TQ / 16;      // one warp per 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int LDB = DH + 8;         // bf16 pitch of the Q/K/V tiles
constexpr int LDS = TK + 4;         // f32 pitch of a warp's score tile
constexpr int LDP = TK + 8;         // bf16 pitch of a warp's probability tile

constexpr size_t SMEM_BYTES = sizeof(bf16) * (TQ + 2 * TK) * LDB +
                              sizeof(float) * WARPS * 16 * LDS +
                              sizeof(bf16) * WARPS * 16 * LDP;

// Copy 64 token rows of one head (64 bf16 = eight 16-byte chunks each) into
// shared memory; rows at or past n are zero-filled.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride_n, int row0,
                                          int n) {
  for (int i = threadIdx.x; i < 64 * (DH / 8); i += THREADS) {
    const int r = i / (DH / 8);
    const int c = (i % (DH / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      v = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * stride_n + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LDB + c) = v;
  }
}

template <bool SCALED>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int n,
                 long long q_sb, long long q_sn, long long k_sb,
                 long long k_sn, long long v_sb, long long v_sn,
                 long long o_sb, long long o_sn, float scale) {
  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qb = q + b * q_sb + h * DH;
  const bf16* kb = k + b * k_sb + h * DH;
  const bf16* vb = v + b * v_sb + h * DH;
  bf16* ob = o + b * o_sb + h * DH;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + TQ * LDB;
  bf16* sV = sK + TK * LDB;
  float* sS = reinterpret_cast<float*>(sV + TK * LDB);
  bf16* sP = reinterpret_cast<bf16*>(sS + WARPS * 16 * LDS);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* wS = sS + warp * 16 * LDS;
  bf16* wP = sP + warp * 16 * LDP;

  load_tile(sQ, qb, q_sn, q0, n);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * LDB + kk * 16, LDB);
  }

  // Softmax bookkeeping: two lanes per query row, 32 columns each.
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 32;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int kv0 = 0; kv0 < n; kv0 += TK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sK, kb, k_sn, kv0, n);
    load_tile(sV, vb, v_sn, kv0, n);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows: (16 x 64) f32.
#pragma unroll
    for (int j = 0; j < TK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sK + j * 16 * LDB + kk * 16, LDB);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(wS + j * 16, sf, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax in f32. Each tile holds at least one real key, so the
    // row max is finite after the first tile.
    float s[32];
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float logit = SCALED ? __fmul_rn(wS[r * LDS + c0 + i], scale)
                                 : wS[r * LDS + c0 + i];
      s[i] = (kv0 + c0 + i < n) ? logit : -INFINITY;
      tmax = fmaxf(tmax, s[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);  // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[i] *= alpha;
      const float p = expf(s[i] - m_new);
      l += p;
      wP[r * LDP + c0 + i] = __float2bfloat16(p);  // bf16 P, as on the TPU
    }
    m = m_new;
    __syncwarp();

    // O_tile = P V: (16 x 64) bf16 x (64 x 64) bf16 -> f32.
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::fill_fragment(of, 0.f);
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, wP + kk * 16, LDP);
        wmma::load_matrix_sync(vf, sV + kk * 16 * LDB + j * 16, LDB);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(wS + j * 16, of, LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += wS[r * LDS + c0 + i];
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  const int row = q0 + warp * 16 + r;
  if (row < n) {
    bf16* dst = ob + (long long)row * o_sn + c0;
#pragma unroll
    for (int i = 0; i < 32; ++i) dst[i] = __float2bfloat16(acc[i] / l);
  }
}

template <bool SCALED>
int run(const void* q, const void* k, const void* v, void* o, int batch,
        int n, int heads, long long q_sb, long long q_sn, long long k_sb,
        long long k_sn, long long v_sb, long long v_sn, long long o_sb,
        long long o_sn, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<SCALED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + TQ - 1) / TQ, heads, batch);
  attention_kernel<SCALED><<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, n, q_sb, q_sn,
      k_sb, k_sn, v_sb, v_sn, o_sb, o_sn, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/o: bf16 (B, N, H, 64) with the (H, 64) pair contiguous; the batch and
// token strides are given in elements. Returns cudaGetLastError().
// vrvg_attention takes q pre-scaled and ignores `scale` (row 2);
// vrvg_flash_attention multiplies the f32 logits by `scale` (row 17).
extern "C" int vrvg_attention(const void* q, const void* k, const void* v,
                              void* o, int batch, int n, int heads,
                              long long q_sb, long long q_sn, long long k_sb,
                              long long k_sn, long long v_sb, long long v_sn,
                              long long o_sb, long long o_sn, float scale,
                              void* stream) {
  return run<false>(q, k, v, o, batch, n, heads, q_sb, q_sn, k_sb, k_sn, v_sb,
                    v_sn, o_sb, o_sn, scale, stream);
}

extern "C" int vrvg_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int batch, int n,
                                    int heads, long long q_sb, long long q_sn,
                                    long long k_sb, long long k_sn,
                                    long long v_sb, long long v_sn,
                                    long long o_sb, long long o_sn,
                                    float scale, void* stream) {
  return run<true>(q, k, v, o, batch, n, heads, q_sb, q_sn, k_sb, k_sn, v_sb,
                   v_sn, o_sb, o_sn, scale, stream);
}
