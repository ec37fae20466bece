// Softmax attention of the DINOv2 blocks at f32, for Hopper (sm_90a): the
// f32 variant of csrc/attention.cu for --compute_dtype float32, one kernel
// built twice.
//
// attention_f32_kernel<false> replaces vr_video_generator_tpu/ops/
// attention_pallas.py `oneshot_mha_heads` (kernel body `_kernel`, row 2, up
// to 4096 tokens) run at f32: q arrives pre-scaled, logits, softmax and the
// PV product are f32, the output is o / l.
// attention_f32_kernel<true> replaces the JAX library flash kernel that
// vr_video_generator_tpu/ops/attention.py `_flash_mha` calls past 4096
// tokens (row 17) at f32: q is unscaled and the f32 logits are multiplied
// by sm_scale in f32 before the softmax.
// Both walk the keys in tiles of 32 with an online softmax (a running max
// m, the sum l and the output rescaled by exp(m_old - m_new) at each tile,
// divided by l once at the end). At f32 that is the one-shot softmax and the
// library's 512-key blocks to f32 rounding: nothing is cast between the
// products (the bf16 kernels round P to bf16 before PV, which both TPU
// functions do at bf16 and neither does at f32). chip_smoke.py holds each
// instantiation against its plain version (ops/attention.py).
//
// What bounds it on the H100: the two products are 4 * B*H*N^2*64 FLOPs,
// 73.3 GFLOP at vits (B = 8, H = 6, N = 2443) and 187.6 at vitl-728 (B = 2,
// H = 16, N = 4785): 1.10 and 2.80 ms at the card's 67 TFLOP/s f32 rate
// outside the tensor cores (wgmma has no f32 operands; TF32 is not f32),
// against 60-80 MB of q/k/v/o: bound by operations.
//
// Design, simple first: one thread a query row, 128 rows a block (grid:
// ceil(N/128) x H x B). A thread keeps its q (64 f32) and its output (64
// f32) in registers; the block stages each tile of 32 keys' K and V rows
// (16 KB) in shared memory, loaded as 16-byte vectors by all 128 threads,
// and every thread reads them as broadcasts: the 32 scores of a tile are
// 32 independent FFMA chains over the head dim, PV is 64 independent chains
// over the tile's keys. Keys >= N are never loaded (zeros are staged in
// their place, so p = 0 meets a finite V); their scores are -inf.
// Rows >= N compute on row N - 1 and store nothing. Plain loads,
// __syncthreads and no warp shuffles, so tests/cuda_emu/cuda_runtime.h runs
// it on the CPU (g++). Each FFMA of a score or of PV takes one 16-byte
// shared-memory read per four, so the kernel is bound by shared-memory
// reads before the FFMA rate; register-blocked tiles (several queries a
// thread) or 3xTF32 products on the tensor cores are its later redesign.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;       // head dim
constexpr int BQ = 128;      // query rows (threads) a block
constexpr int KT = 32;       // keys a tile
constexpr int THREADS = BQ;
constexpr int LOADS = KT * DH / 4 / THREADS;  // float4s of K (and V) a thread
constexpr size_t SMEM_BYTES = 2 * KT * DH * sizeof(float);

__device__ __forceinline__ unsigned char* attention_shared() {
  extern __shared__ __align__(16) unsigned char smem[];
  return smem;
}

// q/k/v/o (B, N, H, 64) f32 with the (H, 64) pair contiguous; batch and
// token strides in elements.
template <bool SCALED>
__global__ void __launch_bounds__(THREADS)
    attention_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int n, long long q_sb, long long q_sn,
                         long long k_sb, long long k_sn, long long v_sb,
                         long long v_sn, long long o_sb, long long o_sn,
                         float scale) {
  float* ks = reinterpret_cast<float*>(attention_shared());  // [KT][DH]
  float* vs = ks + KT * DH;                                  // [KT][DH]
  const int h = blockIdx.y, b = blockIdx.z;
  const int qi = blockIdx.x * BQ + threadIdx.x;
  const int qr = qi < n ? qi : n - 1;

  float qv[DH], ov[DH];
  const float* qp = q + b * q_sb + (long long)qr * q_sn + h * DH;
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    const float4 t = *reinterpret_cast<const float4*>(qp + d);
    qv[d] = t.x, qv[d + 1] = t.y, qv[d + 2] = t.z, qv[d + 3] = t.w;
    ov[d] = ov[d + 1] = ov[d + 2] = ov[d + 3] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const float* kb = k + b * k_sb + h * DH;
  const float* vb = v + b * v_sb + h * DH;
  const int tiles = (n + KT - 1) / KT;
  for (int t = 0; t < tiles; ++t) {
    const int key0 = t * KT;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = threadIdx.x + THREADS * i;  // float4 e of the tile
      const int key = e / (DH / 4), d = e % (DH / 4) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key0 + key < n) {
        kv = *reinterpret_cast<const float4*>(kb + (key0 + key) * k_sn + d);
        vv = *reinterpret_cast<const float4*>(vb + (key0 + key) * v_sn + d);
      }
      *reinterpret_cast<float4*>(ks + key * DH + d) = kv;
      *reinterpret_cast<float4*>(vs + key * DH + d) = vv;
    }
    __syncthreads();
    const int valid = n - key0 < KT ? n - key0 : KT;
    float s[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) s[j] = 0.f;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + j * DH + d);
        s[j] = fmaf(qv[d], kv.x, s[j]);
        s[j] = fmaf(qv[d + 1], kv.y, s[j]);
        s[j] = fmaf(qv[d + 2], kv.z, s[j]);
        s[j] = fmaf(qv[d + 3], kv.w, s[j]);
      }
    }
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (SCALED) s[j] = __fmul_rn(s[j], scale);
      if (j >= valid) s[j] = -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    // Every tile holds a real key, so m_new is finite; alpha is 0 at the
    // first tile (m = -inf).
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(__fsub_rn(m, m_new));
    m = m_new;
    l = __fmul_rn(l, alpha);
#pragma unroll
    for (int d = 0; d < DH; ++d) ov[d] = __fmul_rn(ov[d], alpha);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float p = expf(__fsub_rn(s[j], m_new));
      l = __fadd_rn(l, p);
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + j * DH + d);
        ov[d] = fmaf(p, vv.x, ov[d]);
        ov[d + 1] = fmaf(p, vv.y, ov[d + 1]);
        ov[d + 2] = fmaf(p, vv.z, ov[d + 2]);
        ov[d + 3] = fmaf(p, vv.w, ov[d + 3]);
      }
    }
    __syncthreads();
  }
  if (qi < n) {
    float* op = o + b * o_sb + (long long)qi * o_sn + h * DH;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      *reinterpret_cast<float4*>(op + d) =
          make_float4(__fdiv_rn(ov[d], l), __fdiv_rn(ov[d + 1], l),
                      __fdiv_rn(ov[d + 2], l), __fdiv_rn(ov[d + 3], l));
    }
  }
}

template <bool SCALED>
int run(const void* q, const void* k, const void* v, void* o, int batch,
        int n, int heads, long long q_sb, long long q_sn, long long k_sb,
        long long k_sn, long long v_sb, long long v_sn, long long o_sb,
        long long o_sn, float scale, void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0) return (int)cudaSuccess;
  const dim3 grid((n + BQ - 1) / BQ, heads, batch);
  attention_f32_kernel<SCALED><<<grid, THREADS, SMEM_BYTES,
                                 (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, n, q_sb,
      q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/o: f32 (B, N, H, 64) with the (H, 64) pair contiguous and 16-byte
// aligned rows; the batch and token strides are given in elements. Returns
// cudaGetLastError(). vrvg_attention_f32 takes q pre-scaled and ignores
// `scale` (row 2); vrvg_flash_attention_f32 multiplies the f32 logits by
// `scale` (row 17).
extern "C" int vrvg_attention_f32(const void* q, const void* k,
                                  const void* v, void* o, int batch, int n,
                                  int heads, long long q_sb, long long q_sn,
                                  long long k_sb, long long k_sn,
                                  long long v_sb, long long v_sn,
                                  long long o_sb, long long o_sn, float scale,
                                  void* stream) {
  return run<false>(q, k, v, o, batch, n, heads, q_sb, q_sn, k_sb, k_sn, v_sb,
                    v_sn, o_sb, o_sn, scale, stream);
}

extern "C" int vrvg_flash_attention_f32(const void* q, const void* k,
                                        const void* v, void* o, int batch,
                                        int n, int heads, long long q_sb,
                                        long long q_sn, long long k_sb,
                                        long long k_sn, long long v_sb,
                                        long long v_sn, long long o_sb,
                                        long long o_sn, float scale,
                                        void* stream) {
  return run<true>(q, k, v, o, batch, n, heads, q_sb, q_sn, k_sb, k_sn, v_sb,
                   v_sn, o_sb, o_sn, scale, stream);
}
