// refinenet1's residual-unit pair, rcu2(path2 + rcu1(rn0)), for Hopper
// (sm_90a), as a chain of four 3x3 convolutions (C -> C):
//
//   rb  = bf16(relu(b1a + conv1a(relu(rn0))))
//   t   = bf16(b2a + conv2a(rb) + rn0 + path2)
//   rd  = bf16(relu(b1b + conv1b(relu(t))))
//   out = bf16(b2b + conv2b(rd) + t)
//
// Replaces: vr_video_generator_tpu/attic/refinenet_pre.py `_rcu_pair_kernel`
// (refinenet_pre_pallas), at its rounding points (:92-121): the f32 bias
// and the f32 products make each accumulator, the ReLU is applied to the
// loaded input and to the output where that kernel has one, the residuals
// are added in f32 in its order (acc + rn0 + path2, then acc + t), every
// conv zero-pads its own input (the image edges), and each conv's output is
// cast to bf16, as the TPU kernel casts each scratch to the input dtype.
// The output is NHWC (B, H0, W0, C): the TPU kernel's channel-major layout
// with a 4-column halo was a Mosaic constraint for its consumer, and the
// port's ext tail reads NHWC.
//
// What bounds it on the H100: at 1080p/vits (B = 8, 148 x 264, C = 64) the
// four convs are 4 x 2 x 9 x 64 x 64 MAC per pixel, ~92 GFLOP (93 us at the
// 989 TFLOP/s bf16 peak), against ~2.5 x 40 MB of bf16 inputs and output
// (30 us at 3.35 TB/s): compute-bound; at vitb's C = 128, 369 GFLOP (0.37
// ms). The TPU kernel keeps a row band's intermediates in VMEM and
// recomputes a 12-row halo; here each conv is its own launch with its bf16
// output in device memory (three 40-80 MB round trips, 0.04-0.07 ms), so
// each conv can be held alone against its plain version.
//
// Design: each conv is an implicit GEMM on the persistent TMA + wgmma core
// (csrc/wgmma_gemm.cuh, conv3x3 with Conv3x3Layout): K = 9 C in slices of
// 64 channels of one tap, A one 4-D TMA box of the image a stage (TMA's zero
// fill is the padding), B the weights as (C, 9 C); tiles of image rows x 32
// pixels by all C output channels: 256 x 64 (8 rows, m64n64k16 products) at
// C = 64, 128 x 128 (4 rows) at C = 128. The consumers take the f32 sums
// through the core's f32 step (RcuSums): + the f32 bias, the ReLU, the bf16
// residuals read at the tile's pixels, then the one cast. A TMA load cannot
// take a ReLU on the way, and ReLU of a bf16 value is exact, so the input
// ReLUs are made beforehand: relu(rn0) by a pass over rn0 (relu_kernel)
// before conv1a, and relu(t) by conv2a's epilogue warps, which write it
// beside t as they store the tile. The residual loads sit on the
// consumers' path between two tiles' products: on an H100 at vits' 1080p
// grid conv2a (two residuals) took 0.136 ms against conv1a's 0.074, and at
// C = 128 the 256 x 128 tile's 128 accumulators left the step's loads too
// few registers (the chain took 1.49 ms so, 1.09 on 128 x 128 tiles).

#include "wgmma_gemm.cuh"

namespace {

using namespace vrvg;

constexpr int P = tma_gemm::Conv3x3Layout::P;

// The f32 step of one conv of the chain on Shape's tiles: + bias, with RELU
// a ReLU, then NRES bf16 residuals (B, H, W, C) added in f32 in order;
// `relu_copy` (or null), (B, H, W, C), takes relu of the bf16 output, from
// the epilogue warps.
template <class Shape, bool RELU, int NRES>
struct RcuSums {
  static constexpr int CONSUMER_BOXES = 0;
  static constexpr bool GATED = false;
  static constexpr bool F32_STEP = true;
  const bf16* bias;  // not added; named as every epilogue's bias is
  const float* sum_bias;  // (C,) f32
  const bf16* res0;
  const bf16* res1;
  bf16* relu_copy;
  int c, h, w, tiles_x, tiles_y;

  // The pixel (b H + y) W + x of GEMM row `row` of Conv3x3Layout's tiles,
  // or -1 past the image (a tile's overhang, clipped by the store).
  __device__ __forceinline__ long long pixel(int row) const {
    constexpr int BM = Shape::BM;
    const int tile = row / BM, r = row - tile * BM;
    const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
    const int y = ty % tiles_y * (BM / P) + r / P, x = tx * P + r % P;
    return y < h && x < w ? ((long long)(ty / tiles_y) * h + y) * w + x : -1;
  }

  // The residual loads have no branch (a row past the image reads pixel 0;
  // its result is clipped by the store), so those of a thread's unrolled
  // calls issue together rather than one latency each.
  __device__ __forceinline__ void f32_step(float& v0, float& v1, int row,
                                           int col) const {
    __nv_bfloat162 r[NRES > 0 ? NRES : 1];
    if constexpr (NRES > 0) {
      const long long p = pixel(row);
      const long long off = (p < 0 ? 0 : p) * c + col;
      r[0] = __ldg(reinterpret_cast<const __nv_bfloat162*>(res0 + off));
      if constexpr (NRES > 1) {
        r[1] = __ldg(reinterpret_cast<const __nv_bfloat162*>(res1 + off));
      }
    }
    v0 = __fadd_rn(v0, __ldg(sum_bias + col));
    v1 = __fadd_rn(v1, __ldg(sum_bias + col + 1));
    if (RELU) {
      v0 = fmaxf(v0, 0.f);
      v1 = fmaxf(v1, 0.f);
    }
#pragma unroll
    for (int i = 0; i < NRES; ++i) {
      v0 = __fadd_rn(v0, __low2float(r[i]));
      v1 = __fadd_rn(v1, __high2float(r[i]));
    }
  }

  template <int N>
  __device__ __forceinline__ void operator()(bf16 (&v)[N], int row,
                                             int col) const {
    if (relu_copy == nullptr) return;
    const long long p = pixel(row);
    if (p < 0) return;
    __align__(16) bf16 r[N];
#pragma unroll
    for (int e = 0; e < N; ++e) r[e] = bf(v[e]) > 0.f ? v[e] : rbf(0.f);
    typedef typename tma_gemm::Bits<N>::T T;
    *reinterpret_cast<T*>(relu_copy + p * c + col) =
        *reinterpret_cast<const T*>(r);
  }
};

// out = relu(in) over n bf16 values (n a multiple of 8, 16-byte aligned),
// 16 bytes a thread, grid-stride; -0 and NaN become +0, as the earlier
// kernel's load did.
constexpr int RELU_THREADS = 256;

__global__ void __launch_bounds__(RELU_THREADS)
relu_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
            long long n8) {
  for (long long i = blockIdx.x * (long long)RELU_THREADS + threadIdx.x;
       i < n8; i += (long long)gridDim.x * RELU_THREADS) {
    uint4 v = in[i];
    bf16* e8 = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (!(bf(e8[e]) > 0.f)) e8[e] = rbf(0.f);
    }
    out[i] = v;
  }
}

template <class Shape, bool RELU, int NRES>
int conv(const void* in, const void* wt, const void* bias, const void* res0,
         const void* res1, void* out, void* relu_copy, int batch, int h,
         int w, int c, void* stream) {
  RcuSums<Shape, RELU, NRES> epi;
  epi.bias = nullptr;
  epi.sum_bias = (const float*)bias;
  epi.res0 = (const bf16*)res0;
  epi.res1 = (const bf16*)res1;
  epi.relu_copy = (bf16*)relu_copy;
  epi.c = c;
  epi.h = h;
  epi.w = w;
  epi.tiles_x = (w + P - 1) / P;
  epi.tiles_y = (h + Shape::BM / P - 1) / (Shape::BM / P);
  return tma_gemm::conv3x3<Shape>(in, wt, out, batch, h, w, c, c, epi,
                                  stream);
}

template <class Shape>
int run(const void* in, const void* wt, const void* bias, const void* res0,
        const void* res1, void* out, void* relu_copy, int batch, int h,
        int w, int c, int relu, int nres, void* stream) {
  if (relu && nres == 0 && relu_copy == nullptr) {
    return conv<Shape, true, 0>(in, wt, bias, res0, res1, out, nullptr,
                                batch, h, w, c, stream);
  }
  if (!relu && nres == 2) {
    return conv<Shape, false, 2>(in, wt, bias, res0, res1, out, relu_copy,
                                 batch, h, w, c, stream);
  }
  if (!relu && nres == 1) {
    return conv<Shape, false, 1>(in, wt, bias, res0, res1, out, relu_copy,
                                 batch, h, w, c, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One conv of the chain: in (B, H0, W0, C) bf16 contiguous; with relu and a
// non-null `in_relu` (B, H0, W0, C) scratch, relu(in) is written there
// first and the conv reads it, with relu and a null one `in` is relu'd
// already; its weights (C, 9 C) bf16 (k = (3 dh + dw) C + c) and bias (C,)
// f32; `nres` residuals (B, H0, W0, C) bf16 -> out (B, H0, W0, C) bf16, and
// relu(out) into `out_relu` unless it is null. The chain's three kinds:
// relu = 1 with no residual (conv1a, conv1b), relu = 0 with two (conv2a:
// rn0, path2, and relu(t)) or one (conv2b: t). C in {64, 128}. Returns a
// CUDA error code.
extern "C" int vrvg_rcu_conv(const void* in, void* in_relu, const void* wt,
                             const void* bias, const void* res0,
                             const void* res1, void* out, void* out_relu,
                             int batch, int h, int w, int c, int relu,
                             int nres, void* stream) {
  if (c != 64 && c != 128) return (int)cudaErrorInvalidValue;
  if (in_relu != nullptr && !relu) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || h <= 0 || w <= 0) return (int)cudaSuccess;
  if (in_relu != nullptr) {
    const long long n8 = (long long)batch * h * w * c / 8;
    const long long blocks = (n8 + RELU_THREADS - 1) / RELU_THREADS;
    relu_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), RELU_THREADS, 0,
                  (cudaStream_t)stream>>>((const uint4*)in, (uint4*)in_relu,
                                          n8);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    in = in_relu;
  }
  if (c == 64) {
    return run<tma_gemm::Tile<256, 64>>(in, wt, bias, res0, res1, out,
                                        out_relu, batch, h, w, c, relu, nres,
                                        stream);
  }
  return run<tma_gemm::Tile<128, 128>>(in, wt, bias, res0, res1, out,
                                       out_relu, batch, h, w, c, relu, nres,
                                       stream);
}
