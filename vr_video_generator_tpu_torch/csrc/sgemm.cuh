// An f32 GEMM core on the CUDA cores (SIMT FFMA), for the f32 variants of
// the kernels on a `--compute_dtype float32` path: C (M x N) = epilogue(A (M
// x K) B^T), A and B K-major (B an nn.Linear weight (N, K)), f32 products
// and sums throughout, C f32.
//
// Why not the tensor cores: wgmma takes no f32 operands, and TF32 (the
// tensor cores' "f32") rounds each operand to 10 mantissa bits, about three
// decimal digits, which is not f32 (the JAX package's f32 path multiplies in
// f32). So this core is bound by the card's f32 rate outside the tensor
// cores, 67 TFLOP/s on an H100 SXM, about 1/15 of the bf16 one. 3xTF32,
// each operand split into a TF32 head and tail and three tensor-core products
// summed in f32, keeps f32 accuracy on the tensor cores: rows 8, 9, 10, 11
// and 12 at f32 run so (csrc/tf32x3_gemm.cuh); the rows left here (5, 6, 7,
// 15 and 16) are next.
//
// Design: the classic register-blocked SIMT product. A block of 256 threads
// computes a BM x BN tile of C; each thread owns TM x TN outputs (8 x 8 for
// the dense rows: 64 f32 accumulators), read as RM vectors of VM rows and RN
// vectors of 4 columns, BM / RM and BN / RN apart, so a warp's vector loads
// from shared memory fall on distinct banks or broadcast. K is staged
// through shared memory BK = 8 at a time, A and B tiles stored k-major
// (transposed) with a pitch of 4 extra floats, in two buffers: the next
// slice's global loads are issued into registers before the current slice's
// products and stored into the other buffer after them, one __syncthreads a
// slice. Each slice is BK x TM x TN FFMAs a thread against (RM + RN) vector
// loads from shared memory a k. Plain loads, __syncthreads and no warp
// shuffles, so tests/cuda_emu/cuda_runtime.h runs it on the CPU (g++).
//
// Operands. A and B are structs with
//   struct Row;                                  // a row's precomputed base
//   __device__ Row row(int r) const;             // r may be >= the row count
//   __device__ float4 load4(const Row&, int k) const;  // A[r, k : k + 4]
// returning zeros past the rows or K (K a multiple of 4): DenseRows reads an
// (R, K) row-major matrix; Conv3x3Rows (csrc/sconv.cuh) makes A the
// im2col of a (B, H, W, C) image read in place, an implicit GEMM.
// An epilogue is a struct with
//   template <class T>
//   __device__ void store(int row, int n0, int tx,
//                         const float (&v)[T::TN]) const;
// given a thread's sums v of one row < M of C, at the columns
// T::col(n0, tx, j) (groups of 4; a group may start at or past N, which the
// epilogue skips: N is a multiple of 4). It writes C itself.
// Shared memory is the kernel's dynamic shared memory (smem_bytes<T>()), at
// most 48 KB for the tiles used, so no attribute is needed.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "epilogue_f32.cuh"

namespace {

// The block's dynamic shared memory, declared in the unnamed namespace (the
// emulation's shared array lives there too).
__device__ __forceinline__ unsigned char* sgemm_shared() {
  extern __shared__ __align__(16) unsigned char smem[];
  return smem;
}

namespace sgemm {

constexpr int BK = 8;          // K a shared-memory slice
constexpr int THREADS = 256;

template <int BM_, int BN_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int TY = BM / TM, TX = BN / TN;  // threads along M, N
  static_assert(TX * TY == THREADS, "a tile is 256 threads");
  static_assert(TM == 2 || TM % 4 == 0, "TM is 2 or a multiple of 4");
  static_assert(TN % 4 == 0, "TN is a multiple of 4");
  static constexpr int VM = TM < 4 ? TM : 4;  // rows read as one vector
  static constexpr int RM = TM / VM;          // vectors, BM / RM rows apart
  static constexpr int RN = TN / 4;           // 4-column vectors, BN / RN apart
  static constexpr int PM = BM + 4, PN = BN + 4;  // shared pitches (floats)
  static constexpr int QA = BM * BK / 4, QB = BN * BK / 4;  // float4s a slice
  static constexpr int LA = (QA + THREADS - 1) / THREADS;   // ... a thread
  static constexpr int LB = (QB + THREADS - 1) / THREADS;
  // Row of the tile of a thread's output i (0 <= i < TM), column of its
  // output j (0 <= j < TN).
  __host__ __device__ static int row(int ty, int i) {
    return (i / VM) * (BM / RM) + ty * VM + i % VM;
  }
  __host__ __device__ static int col(int n0, int tx, int j) {
    return n0 + (j / 4) * (BN / RN) + tx * 4 + j % 4;
  }
};

template <class T>
constexpr size_t smem_bytes() {
  return 2 * BK * (T::PM + T::PN) * sizeof(float);
}

// An (R, K) row-major matrix with leading dimension ld (a multiple of 4,
// the base 16-byte aligned).
struct DenseRows {
  const float* a;
  long long ld;
  int rows, k;
  struct Row {
    const float* p;  // null past the rows
  };
  __device__ __forceinline__ Row row(int r) const {
    return Row{r < rows ? a + (long long)r * ld : nullptr};
  }
  __device__ __forceinline__ float4 load4(const Row& r, int kk) const {
    if (r.p == nullptr || kk >= k) return make_float4(0.f, 0.f, 0.f, 0.f);
    return *reinterpret_cast<const float4*>(r.p + kk);
  }
};

// One slice's global loads of a thread: float4 q = tid + THREADS l of the
// tile's Q float4s is row q / 2, k (q % 2) * 4 of the slice.
template <int L, int Q, class Op>
__device__ __forceinline__ void fetch(float4 (&reg)[L],
                                      const typename Op::Row (&rows)[L],
                                      const Op& op, int k0) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int q = threadIdx.x + THREADS * l;
    if (Q % THREADS == 0 || q < Q) reg[l] = op.load4(rows[l], k0 + q % 2 * 4);
  }
}

template <int L, int Q, int P>
__device__ __forceinline__ void stash(float* s, const float4 (&reg)[L]) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int q = threadIdx.x + THREADS * l;
    if (Q % THREADS == 0 || q < Q) {
      const int r = q / 2, k = q % 2 * 4;
      s[(k + 0) * P + r] = reg[l].x;
      s[(k + 1) * P + r] = reg[l].y;
      s[(k + 2) * P + r] = reg[l].z;
      s[(k + 3) * P + r] = reg[l].w;
    }
  }
}

template <int V>
__device__ __forceinline__ void read_vec(float* dst, const float* src) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x, dst[1] = t.y, dst[2] = t.z, dst[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x, dst[1] = t.y;
  }
}

// Block (blockIdx.x, blockIdx.y) = C's tile (n0, m0): the N tiles of a row
// band are neighbours in launch order, so they share A's rows in L2.
template <class T, class OpA, class OpB, class Epi>
__global__ void __launch_bounds__(THREADS)
    sgemm_kernel(OpA a, OpB b, int m, int k, Epi epi) {
  float* as = reinterpret_cast<float*>(sgemm_shared());  // [2][BK][PM]
  float* bs = as + 2 * BK * T::PM;                       // [2][BK][PN]
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
  const int n0 = blockIdx.x * T::BN;
  const int m0 = blockIdx.y * T::BM;

  typename OpA::Row arow[T::LA];
  typename OpB::Row brow[T::LB];
#pragma unroll
  for (int l = 0; l < T::LA; ++l)
    arow[l] = a.row(m0 + (threadIdx.x + THREADS * l) / 2);
#pragma unroll
  for (int l = 0; l < T::LB; ++l)
    brow[l] = b.row(n0 + (threadIdx.x + THREADS * l) / 2);

  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;

  float4 ra[T::LA], rb[T::LB];
  fetch<T::LA, T::QA>(ra, arow, a, 0);
  fetch<T::LB, T::QB>(rb, brow, b, 0);
  stash<T::LA, T::QA, T::PM>(as, ra);
  stash<T::LB, T::QB, T::PN>(bs, rb);
  __syncthreads();
  const int slices = (k + BK - 1) / BK;
  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < slices;
    if (more) {
      fetch<T::LA, T::QA>(ra, arow, a, (s + 1) * BK);
      fetch<T::LB, T::QB>(rb, brow, b, (s + 1) * BK);
    }
    const float* sa = as + cur * BK * T::PM;
    const float* sb = bs + cur * BK * T::PN;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[T::TM], bv[T::TN];
#pragma unroll
      for (int i = 0; i < T::RM; ++i)
        read_vec<T::VM>(av + i * T::VM,
                        sa + kk * T::PM + T::row(ty, i * T::VM));
#pragma unroll
      for (int j = 0; j < T::RN; ++j)
        read_vec<4>(bv + 4 * j, sb + kk * T::PN + T::col(0, tx, 4 * j));
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      stash<T::LA, T::QA, T::PM>(as + (cur ^ 1) * BK * T::PM, ra);
      stash<T::LB, T::QB, T::PN>(bs + (cur ^ 1) * BK * T::PN, rb);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int r = m0 + T::row(ty, i);
    if (r < m) epi.template store<T>(r, n0, tx, acc[i]);
  }
}

// C = epi(A B^T) on `stream`: M rows, N columns (a multiple of 4), K (a
// multiple of 4). Returns cudaGetLastError().
template <class T, class OpA, class OpB, class Epi>
int gemm(const OpA& a, const OpB& b, int m, int n, int k, const Epi& epi,
         void* stream) {
  if (n % 4 || k % 4) return (int)cudaErrorInvalidValue;
  if (m <= 0 || n <= 0) return (int)cudaSuccess;
  const dim3 grid((n + T::BN - 1) / T::BN, (m + T::BM - 1) / T::BM);
  sgemm_kernel<T, OpA, OpB, Epi><<<grid, THREADS, smem_bytes<T>(),
                                   (cudaStream_t)stream>>>(a, b, m, k, epi);
  return (int)cudaGetLastError();
}

// Each 4-column group of a thread's row that lies below n: f(col, v4).
template <class T, class F>
__device__ __forceinline__ void for_each4(int n0, int tx, int n,
                                          const float (&v)[T::TN], F f) {
#pragma unroll
  for (int j = 0; j < T::TN; j += 4) {
    const int c = T::col(n0, tx, j);
    if (c < n) f(c, v + j);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// C = A B^T into an (M, N) row-major f32 matrix.
struct Store {
  float* c;
  int n;
  template <class T>
  __device__ __forceinline__ void store(int row, int n0, int tx,
                                        const float (&v)[T::TN]) const {
    float* dst = c + (long long)row * n;
    for_each4<T>(n0, tx, n, v, [&](int col, const float* s) {
      *reinterpret_cast<float4*>(dst + col) = make_float4(s[0], s[1], s[2],
                                                          s[3]);
    });
  }
};

// C = A B^T + bias (f32, (N,)): row 7's conv1 at f32.
struct BiasStore {
  float* c;
  const float* bias;
  int n;
  template <class T>
  __device__ __forceinline__ void store(int row, int n0, int tx,
                                        const float (&v)[T::TN]) const {
    float* dst = c + (long long)row * n;
    for_each4<T>(n0, tx, n, v, [&](int col, const float* s) {
      const float4 b = ld4(bias + col);
      *reinterpret_cast<float4*>(dst + col) =
          make_float4(__fadd_rn(s[0], b.x), __fadd_rn(s[1], b.y),
                      __fadd_rn(s[2], b.z), __fadd_rn(s[3], b.w));
    });
  }
};

// out = x + gamma * (A B^T + bias), all (M, N) or (N,) f32: row 6's
// epilogue at f32 (proj + LayerScale + residual; vrvg::ls_residual_f32),
// each sum and product rounded on its own.
struct LayerScaleResidual {
  float* out;
  const float* x;
  const float* bias;
  const float* gamma;
  int n;
  template <class T>
  __device__ __forceinline__ void store(int row, int n0, int tx,
                                        const float (&v)[T::TN]) const {
    const long long base = (long long)row * n;
    for_each4<T>(n0, tx, n, v, [&](int col, const float* s) {
      const float4 b = ld4(bias + col), g = ld4(gamma + col);
      const float4 r = ld4(x + base + col);
      *reinterpret_cast<float4*>(out + base + col) = make_float4(
          vrvg::ls_residual_f32(s[0], b.x, g.x, r.x),
          vrvg::ls_residual_f32(s[1], b.y, g.y, r.y),
          vrvg::ls_residual_f32(s[2], b.z, g.z, r.z),
          vrvg::ls_residual_f32(s[3], b.w, g.w, r.w));
    });
  }
};

// The tiles: 128 x 128 (8 x 8 a thread) for the dense rows; 256 x 64 for N
// = 64 (row 7's out_conv mix at C = 64); 512 x 32 with a whole 32-column
// row a thread for N = 32 (row 7's conv1 at C2 = 32 and conv2, whose depth
// epilogue needs a pixel's 32 sums in one thread).
typedef Tile<128, 128, 8, 8> Square;
typedef Tile<256, 64, 8, 8> Tall64;
typedef Tile<512, 32, 2, 32> Rows32;

}  // namespace sgemm
}  // namespace
