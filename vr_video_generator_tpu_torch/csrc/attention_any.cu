// Softmax attention of the ViT blocks at any head dim but 64, bf16 or f32,
// for Hopper (sm_90a): rows 2 and 17 at the head dims of a custom
// ModelConfig (csrc/attention.cu and csrc/attention_f32.cu take 64).
//
// attention_any_kernel<T, DP, false> replaces vr_video_generator_tpu/ops/
// attention_pallas.py `oneshot_mha_heads` (kernel body `_kernel`, up to 4096
// tokens), which takes any head dim: q arrives pre-scaled, the logits and
// the softmax statistics are f32, p = exp(s - m) is taken against the row's
// maximum over all keys and cast to the input dtype before PV, PV
// accumulates in f32, and the output is o / l in the input dtype, l the sum
// of the f32 p.
//
// attention_any_kernel<T, DP, true> replaces the JAX library flash kernel
// that vr_video_generator_tpu/ops/attention.py `_flash_mha` calls past 4096
// tokens (jax.experimental.pallas.ops.tpu.flash_attention), at the head
// dims it takes (any with one K block; with several, up to 128 and
// multiples of 128 above, its MIN_BLOCK_SIZE: another raises
// NotImplementedError there and is refused here): q unscaled, the f32
// logits multiplied by sm_scale in f32, and the library's blocks and
// rounding points (ops/attention.flash_attention_plain): K in 512-key
// blocks past 4096 keys (one block below), each block's probabilities taken
// against the running maximum after it and cast to the input dtype, and the
// output kept normalised, O = O (l_corr / l) + PV / l.
// The two differ only in the order of f32 sums.
//
// At f32 every product is an f32 FFMA: no TF32 and no tensor core, so the
// result is f32-accurate (chip_smoke.py holds it against f64 operands and
// shows its bound refusing a TF32 result). At bf16 the operands are widened
// to f32 in shared memory (a bf16 product is exact in f32) and the products
// are FFMAs as well.
//
// What bounds it on the H100: 4 * B*H*N^2*Dh FLOPs (two GEMMs) against the
// q/k/v/o bytes: at 1080p/518 with 12 heads of 32 (B = 8, N = 2443) 73 GFLOP
// against 60 MB, compute-bound (0.074 ms at the 989 TFLOP/s bf16 tensor-core
// peak, 1.1 ms at the 67 TFLOP/s of f32 FFMA). This kernel runs on FFMA and
// computes S = Q K^T twice, so it does 1.5x those FLOPs on units with a
// fifteenth of the tensor cores' rate: a simple kernel that is right, to be
// moved onto the tensor cores later (ROADMAP.md). Above 256, with s =
// ceil(Dh / 256) slices, each of the s column-slice blocks computes S twice
// over the padded 256 s head dims and its own slice of P V: 4 N^2 256 s^2
// + 2 N^2 256 s FLOPs a (batch, head) against 4 N^2 Dh, 3.3x at Dh = 384,
// 2.5x at 512, 4x at 320.
//
// Design. One block of 256 threads per (64-row q tile, head, batch). The
// head dim is zero-padded to DP (16, 32, 64, 128 or 256) in shared memory:
// the zeros add nothing to any dot product. Q (transposed, DP x 64) stays in
// shared memory. Above 256 the head dim runs in DP = 256 slices (the
// shared memory of a wider tile, ~280 KiB at 512, does not fit the SM's
// 227 KiB): S = sum_s Q_s K_s^T, each slice of Q and of the K tile staged
// through the same two buffers in turn, the sums one chain over the head
// dim in the unsliced order (at bf16 its mean difference to the plain
// version was a 33rd of that of summing each slice apart and adding the
// slices, and at f32 neither order came nearer f64); and a grid axis over
// O's 256-wide column slices, each block recomputing S, m and l with the
// same sums in the same order, so the slices' statistics agree bit for bit.
// Two passes over the 64-key tiles of K of each softmax block (all keys, or
// row 17's 512-key blocks):
//   1. S = Q K^T, the row maximum m;
//   2. S again (the same sums in the same order), p = exp(s - m), l += p,
//      p rounded to T into shared memory, then the tile of V over the same
//      buffer as K, and O += P V.
// Against the row's maximum over all keys, row 2 needs no rescaling; row 17
// rescales once a block, as the library does.
// Thread (ty, tx) of the 16 x 16 grid owns S[4 ty + i][4 tx + j] (two
// 16-byte shared loads and 16 FFMAs a step of the head dim) and O[4 ty +
// i][tx + 16 jj]. The row maximum and l are reduced through shared memory
// once a pass, not with warp shuffles. Keys >= N are masked (p = 0; their V
// rows are zeros), rows >= N are computed on zeros and not stored. q, k
// and v are read element by element with their own token and batch strides,
// so they may be strided views into the fused qkv output at any head dim
// (rows need no 16-byte alignment). bf16 travels as its bits (uint16_t),
// converted by integer arithmetic, so the source also compiles with g++
// against the CPU emulation of tests/cuda_emu (tests/test_torch_kernel_
// emulation.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows a block
constexpr int BN = 64;        // keys a tile
constexpr int THREADS = 256;  // a 16 x 16 grid
constexpr int LD = BM + 4;    // row stride of the transposed tiles (floats)
constexpr int RED = 17;       // row stride of the reduction scratch
// Row 17's softmax blocks: one over all keys up to 4096 keys, 512-key blocks
// past that (vr_video_generator_tpu/ops/attention.py _FLASH_BLOCK and its
// block_k rule; ops/attention.FLASH_ONE_BLOCK and FLASH_BLOCK). Both are
// multiples of BN.
constexpr int FLASH_ONE_BLOCK = 4096;
constexpr int FLASH_BLOCK = 512;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const uint16_t* p) {
  return __uint_as_float((uint32_t)*p << 16);
}

// f32 -> bf16 bits, to nearest even (a NaN stays a NaN).
__device__ __forceinline__ uint16_t to_bf16(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (uint16_t)((u >> 16) | 0x40u);
  return (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}
__device__ __forceinline__ float round_to(float f, const float*) { return f; }
__device__ __forceinline__ float round_to(float f, const uint16_t*) {
  return __uint_as_float((uint32_t)to_bf16(f) << 16);
}
__device__ __forceinline__ void store(float* p, float f) { *p = f; }
__device__ __forceinline__ void store(uint16_t* p, float f) {
  *p = to_bf16(f);
}

// Shared memory of a DP-wide block, in floats: Q^T (DP x LD), the K^T (DP x
// LD) or V (BN x DP) tile, P^T (BN x LD), the row reduction (BM x RED), the
// rows' statistic (BM).
constexpr int smem_floats(int dp) {
  return 2 * dp * LD + BN * LD + BM * RED + BM;
}

// Rows [m0, m0 + 64) x head dims [0, DP) of one (batch, head), zero past n
// and past d, into dst[c * LD + r] (transposed). A thread reads four rows at
// one head dim and stores them as one 16-byte word; a warp reads 32
// neighbouring elements of a row and stores to 32 distinct banks.
template <typename T, int DP>
__device__ __forceinline__ void load_t(float* dst, const T* src, long long sn,
                                       int m0, int n, int d, int tid) {
  for (int e = tid; e < 16 * DP; e += THREADS) {
    const int c = e % DP, r0 = 4 * (e / DP);
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = m0 + r0 + u;
      x[u] = r < n && c < d ? load(src + (long long)r * sn + c) : 0.f;
    }
    *reinterpret_cast<float4*>(dst + c * LD + r0) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

// S[i][j] += sum_c Q[4 ty + i][c] K[4 tx + j][c] over one DP-wide slice,
// in the order of c.
template <int DP>
__device__ __forceinline__ void accumulate(float (&s)[4][4], const float* qs,
                                           const float* ks, int ty, int tx) {
#pragma unroll 8
  for (int c = 0; c < DP; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(qs + c * LD + 4 * ty);
    const float4 b = *reinterpret_cast<const float4*>(ks + c * LD + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// S of key tile t: S[i][j] = sum_c Q[4 ty + i][c] K[t BN + 4 tx + j][c]
// (times scale if SCALED), one chain of sums over the head dim in the
// order of c, the same at every call. With one slice Q is resident in qs;
// with several, each slice of Q and of the tile of K (keys < k1) is staged
// into qs and ks in turn. Starts with a barrier: the previous reads of both
// buffers are done.
template <typename T, int DP, bool SCALED>
__device__ __forceinline__ void tile_logits(float (&s)[4][4], float* qs,
                                            float* ks, const T* qb,
                                            const T* kb, long long q_sn,
                                            long long k_sn, int m0, int n,
                                            int t, int k1, int d, int slices,
                                            int ty, int tx, int tid,
                                            float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int sl = 0; sl < slices; ++sl) {
    __syncthreads();
    if (slices > 1) load_t<T, DP>(qs, qb + sl * DP, q_sn, m0, n, d - sl * DP,
                                  tid);
    load_t<T, DP>(ks, kb + sl * DP, k_sn, t * BN, k1, d - sl * DP, tid);
    __syncthreads();
    accumulate<DP>(s, qs, ks, ty, tx);
  }
  if (SCALED) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = __fmul_rn(s[i][j], scale);
  }
}

// Each row's 16 partials (one a tx) combined (max, or sum) into stat[row],
// read back into v[i] for this thread's rows.
template <bool MAX>
__device__ __forceinline__ void reduce_rows(float (&v)[4], float* red,
                                            float* stat, int ty, int tx,
                                            int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) red[(4 * ty + i) * RED + tx] = v[i];
  __syncthreads();
  if (tid < BM) {
    float acc = red[tid * RED];
    for (int t = 1; t < 16; ++t) {
      const float x = red[tid * RED + t];
      acc = MAX ? fmaxf(acc, x) : __fadd_rn(acc, x);
    }
    stat[tid] = acc;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = stat[4 * ty + i];
}

template <typename T, int DP, bool SCALED>
__global__ void __launch_bounds__(THREADS)
    attention_any_kernel(const T* q, const T* k, const T* v, T* o, int n,
                         int d, int slices, long long q_sb, long long q_sn,
                         long long k_sb, long long k_sn, long long v_sb,
                         long long v_sn, long long o_sb, long long o_sn,
                         float scale) {
  constexpr int CPT = DP / 16;  // output columns a thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* kv = qs + DP * LD;
  float* ps = kv + DP * LD;
  float* red = ps + BN * LD;
  float* stat = red + BM * RED;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  // The q tile, and the slice of O's columns [os DP, os DP + dv) it writes.
  const int m0 = blockIdx.x / slices * BM, os = blockIdx.x % slices;
  const int dv = min(DP, d - os * DP);
  const long long hoff = (long long)blockIdx.y * d;
  const int b = blockIdx.z;
  const T* qb = q + b * q_sb + hoff;
  const T* kb = k + b * k_sb + hoff;
  const T* vb = v + b * v_sb + hoff + os * DP;

  if (slices == 1) load_t<T, DP>(qs, qb, q_sn, m0, n, d, tid);

  // Keys in softmax blocks: all of them for row 2 and for row 17 up to 4096
  // keys; past that, row 17 walks 512-key blocks as the library kernel does
  // (ops/attention.flash_attention_plain).
  const int span = SCALED && n > FLASH_ONE_BLOCK ? FLASH_BLOCK : n;
  float acc[4][CPT];  // O: row 2's sums, row 17's normalised output
  float ob[4][CPT];   // row 17: a block's sums
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) acc[i][jj] = 0.f;
  float (&osum)[4][CPT] = SCALED ? ob : acc;
  float m_run[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float l_run[4] = {0.f, 0.f, 0.f, 0.f};
  float s[4][4];
  for (int k0 = 0; k0 < n; k0 += span) {
    const int k1 = min(n, k0 + span);
    // Pass 1: the block's row maximum, then the running one.
    float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    for (int t = k0 / BN; t * BN < k1; ++t) {
      tile_logits<T, DP, SCALED>(s, qs, kv, qb, kb, q_sn, k_sn, m0, n, t, k1,
                                 d, slices, ty, tx, tid, scale);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (t * BN + 4 * tx + j >= k1) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i] = fmaxf(m[i], s[i][j]);
      }
    }
    reduce_rows<true>(m, red, stat, ty, tx, tid);
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = fmaxf(m[i], m_run[i]);

    // Pass 2: p = exp(s - m) against that maximum, its sum l, and
    // O += dtype(p) V.
    if (SCALED) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) osum[i][jj] = 0.f;
    }
    float l[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t = k0 / BN; t * BN < k1; ++t) {
      // (its first barrier: the previous tile's V and P reads are done)
      tile_logits<T, DP, SCALED>(s, qs, kv, qb, kb, q_sn, k_sn, m0, n, t, k1,
                                 d, slices, ty, tx, tid, scale);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = t * BN + 4 * tx + j < k1;
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = valid ? expf(__fsub_rn(s[i][j], m[i])) : 0.f;
          l[i] = __fadd_rn(l[i], p[i]);
        }
        *reinterpret_cast<float4*>(ps + (4 * tx + j) * LD + 4 * ty) =
            make_float4(round_to(p[0], q), round_to(p[1], q),
                        round_to(p[2], q), round_to(p[3], q));
      }
      __syncthreads();  // K^T is read; P is written
      for (int e = tid; e < BN * DP; e += THREADS) {
        const int r = e / DP, c = e % DP;
        float x = 0.f;
        if (t * BN + r < k1 && c < dv) {
          x = load(vb + (long long)(t * BN + r) * v_sn + c);
        }
        kv[e] = x;
      }
      __syncthreads();
#pragma unroll 4
      for (int key = 0; key < BN; ++key) {
        const float4 p = *reinterpret_cast<const float4*>(ps + key * LD +
                                                          4 * ty);
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) {
          const float x = kv[key * DP + tx + 16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            osum[i][jj] = fmaf(pv[i], x, osum[i][jj]);
          }
        }
      }
    }
    reduce_rows<false>(l, red, stat, ty, tx, tid);
    if (SCALED) {
      // The library's update: l_corr = exp(m_run - m) l_run, l' = l +
      // l_corr, O = O (l_corr / l') + sums / l', each f32 step rounded.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float l_corr = __fmul_rn(expf(__fsub_rn(m_run[i], m[i])),
                                       l_run[i]);
        const float l_next = __fadd_rn(l[i], l_corr);
        const float inv = l_next == 0.f ? 1.f : __fdiv_rn(1.f, l_next);
        const float keep = __fmul_rn(l_corr, inv);
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) {
          acc[i][jj] = __fadd_rn(__fmul_rn(acc[i][jj], keep),
                                 __fmul_rn(ob[i][jj], inv));
        }
        m_run[i] = m[i];
        l_run[i] = l_next;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) l_run[i] = l[i];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row >= n) continue;
    T* out = o + b * o_sb + (long long)row * o_sn + hoff + os * DP;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      const int c = tx + 16 * jj;
      if (c < dv) {
        store(out + c, SCALED ? acc[i][jj] : __fdiv_rn(acc[i][jj], l_run[i]));
      }
    }
  }
}

template <typename T, int DP, bool SCALED>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int n, int heads, int d, int slices, long long q_sb,
           long long q_sn,
           long long k_sb, long long k_sn, long long v_sb, long long v_sn,
           long long o_sb, long long o_sn, float scale, void* stream) {
  const size_t bytes = sizeof(float) * smem_floats(DP);
  cudaError_t err = cudaFuncSetAttribute(
      attention_any_kernel<T, DP, SCALED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + BM - 1) / BM * slices, heads, batch);
  attention_any_kernel<T, DP, SCALED>
      <<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (T*)o, n, d, slices, q_sb,
          q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool SCALED>
int dispatch(const void* q, const void* k, const void* v, void* o, int batch,
             int n, int heads, int d, long long q_sb, long long q_sn,
             long long k_sb, long long k_sn, long long v_sb, long long v_sn,
             long long o_sb, long long o_sn, float scale, void* stream) {
#define VRVG_ANY(DP, SLICES)                                                 \
  return launch<T, DP, SCALED>(q, k, v, o, batch, n, heads, d, SLICES, q_sb, \
                               q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn,     \
                               scale, stream)
  if (d <= 16) VRVG_ANY(16, 1);
  if (d <= 32) VRVG_ANY(32, 1);
  if (d <= 64) VRVG_ANY(64, 1);
  if (d <= 128) VRVG_ANY(128, 1);
  VRVG_ANY(256, (d + 255) / 256);
#undef VRVG_ANY
}

}  // namespace

// q/k/v/o: (B, N, H, Dh) with the (H, Dh) pair contiguous, bf16 (f32 == 0)
// or f32; the batch and token strides in elements; Dh >= 1. scaled == 0:
// row 2, q pre-scaled, `scale` ignored; scaled != 0: row 17, the f32 logits
// times `scale`, past FLASH_ONE_BLOCK tokens Dh <= 128 or a multiple of 128
// (the library kernel's rule). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a head dim it refuses.
extern "C" int vrvg_attention_any(const void* q, const void* k, const void* v,
                                  void* o, int batch, int n, int heads, int d,
                                  long long q_sb, long long q_sn,
                                  long long k_sb, long long k_sn,
                                  long long v_sb, long long v_sn,
                                  long long o_sb, long long o_sn, float scale,
                                  int scaled, int f32, void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0) return (int)cudaSuccess;
  if (d < 1 ||
      (scaled && n > FLASH_ONE_BLOCK && d > 128 && d % 128 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
#define VRVG_ARGS                                                         \
  q, k, v, o, batch, n, heads, d, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, \
      o_sn, scale, stream
  if (f32) {
    return scaled ? dispatch<float, true>(VRVG_ARGS)
                  : dispatch<float, false>(VRVG_ARGS);
  }
  return scaled ? dispatch<uint16_t, true>(VRVG_ARGS)
                : dispatch<uint16_t, false>(VRVG_ARGS);
#undef VRVG_ARGS
}
