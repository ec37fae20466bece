// Softmax attention of the DINOv2 blocks, for Hopper (sm_90a): one
// warp-specialised kernel, built twice.
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
// 128-key tiles and divides once at the end. Both are exact online softmaxes
// in f32; they differ only in f32 rounding and in which running max the bf16
// probabilities are taken against, which chip_smoke.py bounds against the
// plain version (ops/attention.flash_attention_plain, the library's order).
// The exponentials are ex2.approx of the logits times log2(e), which moves
// only f32 rounding before the bf16 cast of P.
//
// What bounds it on the H100: the two GEMMs are 4 * B*H*N^2*64 FLOPs (73 GFLOP
// at vits, B=8, H=6, N=2443; 188 GFLOP at vitl-728, B=2, H=16, N=4785)
// against 40-60 MB of q/k/v/o, so it is compute-bound: 0.074 and 0.190 ms at
// the 989 TFLOP/s bf16 peak, if the logits never reach device memory. At
// Dh = 64 the softmax's exponentials (one per logit, 16 a clock on an SM)
// cost as many cycles as the tensor cores' 4 * 64 FLOPs per logit, so the
// exponentials of one warpgroup must run under another's products.
//
// Design: one block of four warpgroups per (192-row q tile, head, batch):
// ceil(N/192) x H x B blocks. Warpgroup 0 is the producer: one thread
// issues TMA loads (4-D tensor maps over (64, H, N, B), 128-byte swizzle) of
// the q tile and of 128-key K and V tiles into a ring of STAGES buffers
// behind full/empty mbarrier pairs, and the warpgroup gives its registers
// to the consumers (setmaxnreg). Warpgroups 1-3 each own 64 query rows:
// S = Q K^T is four wgmma.m64n128k16 from shared memory (both operands
// K-major), the online softmax runs on the f32 accumulator registers (row
// max and sum over the four lanes that share a row, by shuffles; nothing
// goes to shared memory), P is packed to bf16 in registers in the layout of
// wgmma's register A operand, and O += P V is eight wgmma.m64n64k16 with V
// read from shared memory through the transpose bit. O stays in registers
// across all tiles, is divided by l once, and leaves through shared memory
// by a TMA store, which clips rows >= N. TMA zero-fills rows >= N of the
// last q and K/V tiles; the logits of those keys are set to -inf. The three
// consumers share the SM's tensor cores and exponential units without any
// ordering between them, so whichever is in its softmax runs under the
// others' products. k and v may be strided views into the fused qkv
// projection output: the tensor maps take the strides.
//
// The mbarrier, TMA and wgmma helpers are csrc/hopper.cuh's, shared with
// the GEMM core of csrc/wgmma_gemm.cuh.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, kernel table):
// 287-419 TFLOP/s, 0.84-1.05x one scaled_dot_product_attention call at the
// same shapes. Two consumers reached 250-373 TFLOP/s; FA3's ordering of the
// consumers' products (ping-pong) and running P_{t-1} V_{t-1} under the
// softmax of S_t in the same warpgroup were both slower at these shapes.

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace vrvg;

constexpr int DH = 64;           // head dim: one 128-byte row per token
constexpr int CONSUMERS = 3;     // consumer warpgroups, 64 query rows each
constexpr int BM = 64 * CONSUMERS;  // query rows per block
constexpr int BN = 128;          // keys per K/V tile
constexpr int STAGES = 4;        // K/V ring depth
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
// Registers a thread: the producer gives back all but 24, the consumers
// take the rest (24 * 128 + 160 * 384 <= 65536).
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 160;
constexpr uint32_t ROW_BYTES = DH * 2;
constexpr uint32_t TILE_BYTES = BN * ROW_BYTES;  // 16 KB
constexpr uint32_t Q_BYTES = BM * ROW_BYTES;
constexpr uint32_t K_OFF = Q_BYTES;
constexpr uint32_t V_OFF = K_OFF + STAGES * TILE_BYTES;
constexpr uint32_t BAR_OFF = V_OFF + STAGES * TILE_BYTES;
// full[STAGES], empty[STAGES], q; +1024 to align the tiles to the swizzle
// atom (1024 bytes).
constexpr size_t SMEM_BYTES = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
constexpr float LOG2E = 1.4426950408889634f;

// S (64 x 128, f32) (+)= Q (64 x 16) K^T, both from shared memory, K-major.
template <int ACCUMULATE>
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(ACCUMULATE));
}

// O (64 x 64, f32) += P (64 x 16, bf16 registers) V (16 x 64; shared memory,
// MN-major, hence the transpose bit).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

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
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S = Q K^T: four k-steps of 16 over Dh (32 bytes along the row).
__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t dq,
                                         uint64_t dk) {
  wgmma_qk<0>(s, dq, dk);
  wgmma_qk<1>(s, dq + 2, dk + 2);
  wgmma_qk<1>(s, dq + 4, dk + 4);
  wgmma_qk<1>(s, dq + 6, dk + 6);
}

// O += P V: eight k-steps of 16 keys (2048 bytes of V each).
__device__ __forceinline__ void issue_pv(float (&o)[32],
                                         const uint32_t (&p)[32],
                                         uint64_t dv) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    wgmma_pv(o, p[4 * k], p[4 * k + 1], p[4 * k + 2], p[4 * k + 3],
             dv + 128 * k);
  }
}

// Running softmax statistics of a thread's two rows (r0 and r0 + 8): the
// max m and this thread's share of the sum l.
struct RowStats {
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
};

// The online softmax of one S tile on its accumulator registers: logits
// times `scale` (SCALED), keys >= n (TMA's zero rows of the ragged last
// tile, `valid` = n - the tile's first key) to -inf, the new running max,
// alpha = exp(m_old - m_new) for O, l rescaled and summed, and P as bf16
// pairs in wgmma's A-fragment order.
template <bool SCALED>
__device__ __forceinline__ void softmax_tile(float (&s)[64], uint32_t (&p)[32],
                                             RowStats& st, float (&alpha)[2],
                                             int valid, int quad,
                                             float scale) {
  if (SCALED) {
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = __fmul_rn(s[i], scale);
  }
  if (valid < BN) {
    const int lim = valid - 2 * quad;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
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
  for (int j = 0; j < 16; ++j) {
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
  for (int j = 0; j < 16; ++j) {
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

// Register layout of a wgmma f32 accumulator (64 x N) in a warpgroup:
// thread (warp w, lane l) holds rows r0 = 16 w + l / 4 and r0 + 8; value
// 4 j + 2 i + c sits at row r0 + 8 i, column 8 j + 2 (l % 4) + c. Packing
// the pairs (4 j, 4 j + 1) and (4 j + 2, 4 j + 3) to bf16x2 gives, for
// columns 16 k .. 16 k + 15, exactly the four registers of wgmma's A
// fragment of k-step k: (j = 2k, i = 0), (2k, 1), (2k + 1, 0), (2k + 1, 1).
template <bool SCALED>
__global__ void __launch_bounds__(THREADS, 1)
    attention_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to, int n,
                     float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + BAR_OFF;       // + 8 s
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_q = bar_empty + 8 * STAGES;

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (n + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * CONSUMERS);  // one per consumer warp
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
                 : "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, Q_BYTES);
      tma_load_4d(base, &tq, 0, h, q0, b, bar_q);
      int s = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(bar_empty + 8 * s, phase ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * TILE_BYTES);
        tma_load_4d(base + K_OFF + s * TILE_BYTES, &tk, 0, h, t * BN, b,
                    bar_full + 8 * s);
        tma_load_4d(base + V_OFF + s * TILE_BYTES, &tv, 0, h, t * BN, b,
                    bar_full + 8 * s);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS)
                 : "memory");
    const int cw = wg - 1;  // this consumer's 64 rows of the q tile
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int quad = lane & 3;
    const uint32_t q_rows = base + cw * 64 * ROW_BYTES;
    const uint64_t dq = sw128_desc(q_rows, 16);

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float s_acc[64];
    uint32_t p[32];
    RowStats st;
    float alpha[2];

    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int cur = t % STAGES;
      mbar_wait(bar_full + 8 * cur, (t / STAGES) & 1);
      fence_regs(s_acc);
      wgmma_fence();
      issue_qk(s_acc, dq, sw128_desc(base + K_OFF + cur * TILE_BYTES, 16));
      wgmma_commit();
      wgmma_wait();
      fence_regs(s_acc);
      softmax_tile<SCALED>(s_acc, p, st, alpha, n - t * BN, quad, scale);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      issue_pv(o, p, sw128_desc(base + V_OFF + cur * TILE_BYTES, 1024));
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
      fence_regs(p);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * cur);
    }

    // o / l to bf16 in this consumer's (now free) 64 rows of the q tile, in
    // the 128-byte swizzle of the output's tensor map, then one TMA store.
    const float l0 = quad_sum(st.l[0]), l1 = quad_sum(st.l[1]);
    const int r0 = warp * 16 + (lane >> 2);
    unsigned char* out = smem + cw * 64 * ROW_BYTES;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        const float li = i ? l1 : l0;
        *reinterpret_cast<uint32_t*>(out + r * ROW_BYTES +
                                     ((j ^ (r & 7)) << 4) + quad * 4) =
            pack_bf16(o[4 * j + 2 * i] / li, o[4 * j + 2 * i + 1] / li);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
    if (tid == 0 && q0 + cw * 64 < n) {
      tma_store(&to, q_rows, h, q0 + cw * 64, b);
    }
  }
}

// (B, N, H, 64) bf16 with the (H, 64) pair contiguous as a 4-D map over
// (64, H, N, B), boxes of (64, 1, rows, 1), 128-byte swizzle, zero fill.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
              int batch, int n, int heads, long long sb, long long sn,
              uint32_t rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)heads,
                              (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {ROW_BYTES, (cuuint64_t)sn * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)DH, 1, rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool SCALED>
int run(const void* q, const void* k, const void* v, void* o, int batch,
        int n, int heads, long long q_sb, long long q_sn, long long k_sb,
        long long k_sn, long long v_sb, long long v_sn, long long o_sb,
        long long o_sn, float scale, void* stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(encode, &tq, q, batch, n, heads, q_sb, q_sn, BM) ||
      !make_map(encode, &tk, k, batch, n, heads, k_sb, k_sn, BN) ||
      !make_map(encode, &tv, v, batch, n, heads, v_sb, v_sn, BN) ||
      !make_map(encode, &to, o, batch, n, heads, o_sb, o_sn, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<SCALED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + BM - 1) / BM, heads, batch);
  attention_kernel<SCALED><<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      tq, tk, tv, to, n, scale);
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
