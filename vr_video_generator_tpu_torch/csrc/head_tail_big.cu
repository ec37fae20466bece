// The big-C DPT tail (vitl C = 256, vitg C = 384) from refinenet1's
// pre-upsample activation to depth, for Hopper (sm_90a), as two entry
// points of two kernels each:
//
//   front (row 11):
//     0. an NCHW x (the model's activation seen as NHWC) transposed to NHWC;
//     1. upsample pass: the x2 align-corners W-upsample of x -> bf16, the x2
//        H-upsample (f32 lerp) -> bf16: U (B, HM, W2, C), what the TPU
//        kernel keeps in `rz2_s`;
//     2. output_conv1 3x3 (C -> C2 = C/2) with out_conv's 1x1 mix folded
//        into its weights, zero padding, f32 sums -> bf16: mid (B, HM, W2,
//        C2), an implicit GEMM on the TMA + wgmma core
//        (csrc/wgmma_gemm.cuh, Conv3x3Layout).
//   back (row 12):
//     1. resize pass: at each H tap's HM row, the W-resize to the net width
//        (two taps, f32) + out_conv's bias response `cw` (interior / top /
//        bottom row) -> bf16, then the H-resize (f32 lerp) -> bf16: R (B,
//        H1, W1, C2);
//     2. output_conv2 3x3 (C2 -> 32), zero padding, + f32 bias, ReLU, the
//        1x1 (32 -> 1) + bias, ReLU -> f32 depth (B, H1, W1): halo tiles
//        of R by TMA, mma.sync on the tensor cores, the epilogue in
//        registers.
//
// Replaces: vr_video_generator_tpu/ops/head_tail_pallas.py
// `head_tail_big_pallas`: row 11 `_big_front_kernel` and row 12
// `_big_back_kernel`, at their rounding points. The TPU's front also applies
// the W-resize and `cw` and keeps a (B, HM, C2, W1P) bf16 intermediate in
// HBM; here the front stores the post-conv1 product (B, HM, W2, C2) bf16
// instead (its bf16 cast is the same rounding point), and the back applies
// the W-resize and `cw`, rounding to bf16 before the H-resize as the TPU's
// intermediate does. The W-resizes have two non-zero taps per output, so
// fl(wa * a + wb * b) from per-column tap tables (bf16-rounded weights) is
// what the TPU's dense resize GEMM gives. `cw` is computed by the wrapper
// (ops/head_tail.py) in f32 as the JAX package computes it, and added as
// (z + cw0) + top * (cw1 - cw0) + bot * (cw2 - cw0).
//
// What bounds it on the H100: at 1080p/vitl (B = 8, 148 x 264 x 256 in,
// conv1 at 296 x 528 x (256 -> 128), conv2 at 518 x 924 x (128 -> 32)) the
// two convolutions are 737 + 282 GFLOP (0.75 + 0.29 ms at the 989 TFLOP/s
// bf16 peak); at vitg (C = 384) 1659 + 424 GFLOP. Compute-bound, so the
// design keeps the tensor cores fed:
//   - The upsampled conv1 input U (640 MB at vitl-518) is written once by a
//     memory-bound pass (~0.8 GB of traffic) instead of being rebuilt three
//     times by each output row's block, and conv1 reads it in place through
//     TMA: a 3x3 conv is a GEMM with K = 9 C whose K slices are shifted
//     boxes of U, TMA's zero fill is the padding, and the core's persistent
//     ring of TMA loads and wgmma products runs it (256 x 128 tiles, 8 image
//     rows x 32 pixels, at C2 = 128; 128 x 192, 4 rows x 32 pixels, at C2 =
//     192).
//   - conv2 has 32 output channels, too narrow for the core's tiles. Its
//     resized input R is written once by a memory-bound pass, and a
//     persistent kernel walks tiles of 2 output rows x 128 pixels: for each
//     64-channel chunk one TMA box of R (64 ch, 130 px, 4 rows, zero-filled
//     at the image's edges) and the chunk's (9, 32, 64) weights land in a
//     2-stage ring; each of 8 consumer warps takes 32 pixels of one output
//     row (two m16 tiles), and reads the nine taps as ldmatrix rows at shifted pixel
//     offsets (the 128-byte swizzle applied in the address arithmetic) into
//     mma.m16n8k16. So each element of R is read from device memory (4 /
//     2) times, not 3 x 3. b2, ReLU, the 1x1 (a thread's 8 channels, then
//     a quad shuffle), b3 and ReLU run on the accumulator registers.
// The upsample and resize passes are one block per output row (the row's H
// taps computed once), 16 bytes a thread. (A resize pass in bands of 8
// output rows, each HM row's W-resize computed once and staged in shared
// memory, took 0.86 ms at vitl-518 on an H100 against this one's 0.81.) The
// model hands x over as an NCHW activation seen as NHWC; a transpose in 64 x
// 64 tiles makes it NHWC first: 0.17 ms at vitg-518, where PyTorch's copy
// took 0.95 ms; at vitl-518 the transpose and this upsample pass take 0.11 +
// 0.34 ms, where a pass reading the NCHW planes directly in 16-channel
// chunks took 1.23 ms (its 32-byte writes of U scattered).
//
// The ext tail (row 7, head_tail_pallas.py `_tail_ext_kernel`) is built
// from the same kernels, at its own rounding points
// (:287-354), which keep the out_conv mix before the resizes and add its
// bias inside the H-upsample:
//   front (vrvg_head_tail_ext_front):
//     0. the NCHW transpose, as row 11's;
//     1. the out_conv mix per input pixel, (B H0 W0, C) x (C, C)^T on the
//        GEMM core, f32 sums -> bf16: xoc;
//     2. the upsample pass on xoc with out_conv's f32 bias added to the
//        H-lerp before its cast: Z (B, HM, W2, C);
//     3. conv1 3x3 (C -> C2), zero padding, f32 sums + f32 b1, one cast to
//        bf16: c1 (B, HM, W2, C2). At C2 = 64 to 192 an implicit GEMM on the
//        core (row 11's tiles; the BiasBeforeCast epilogue adds b1 to the
//        f32 sums as the consumers stage them); at C2 = 32 (vits) the halo
//        kernel above with b1 and the cast in its registers (Conv1Out): its
//        input (64 channels) and output (32) are conv2's at C2 = 64.
//   back: row 12's entry point without `cw` (an f32 + 0 is exact, so R is
//   the resize pass's bits without it): the resize pass (the W-resize to
//   the net width -> bf16, the H-resize -> bf16) and conv2 with the 1x1.
// At vits (B = 8, 148 x 264 x 64 in, 518 x 924 out) its two convolutions
// are 46 + 71 GFLOP (0.12 ms at the bf16 peak) against ~0.7 GB of
// intermediates written and read (xoc 40 MB, Z 160 MB, c1 80 MB, R 245 MB):
// about as much time on the passes' traffic as on the products. No
// intermediate is held whole in shared memory, so the chain takes any grid
// the JAX planner sends it.
//
// The single-kernel tail (row 15, head_tail_pallas.py `_tail_kernel`,
// vrvg_head_tail) is row 7 without its first three stages (:113-153):
// conv1 (3x3, C -> C2) read straight from path1 (B, H2, W2, C), its f32 sum
// + b1 before the one cast, then row 7's back. So it is a chain of the
// parts above:
//   0. the NCHW transpose of path1 where it comes as NCHW seen as NHWC;
//   1. conv1 with b1 in f32 before the cast: at C2 = 32 (vits' C = 64) the
//      halo kernel (Conv1Out), at C2 = 64 (vitb's C = 128) an implicit GEMM
//      on the core with BiasBeforeCast on 256 x 64 tiles (m64n64k16: the
//      whole of C2 a tile, none of its columns idle);
//   2. row 12's back without `cw`: the resize pass and conv2 with the 1x1.
// At vits' 1080p (B = 8, path1 296 x 528 x 64, depth 518 x 924) the convs
// are 46 + 71 GFLOP (0.12 ms at the bf16 peak), against ~0.6 GB of
// intermediates (c1 80 MB, R 245 MB, each written and read): about as much
// time on traffic as on products. At C = 32 (a custom head) the bf16 tail
// runs csrc/head_tail.cu's wmma chain (head_tail_wmma).
//
// The tails at f32 (--compute_dtype float32): row 7
// (vrvg_head_tail_ext_f32) and rows 11 and 12 (vrvg_head_tail_big_f32) are
// the same chains at the f32
// rounding points of `_tail_ext_kernel` and of `_big_front_kernel` /
// `_big_back_kernel` (every intermediate f32, the resize weights f32,
// conv1's folded weights the f32 fold itself): the NCHW transpose, the
// upsample pass (with out_conv's bias for row 7) and the resize pass (with
// `cw` for row 12) are the kernels above instantiated on f32 (16 bytes a
// thread, 4 channels).
// wgmma takes no f32 operands and TF32 is not f32, so the products run on
// the 3xTF32 wgmma core (csrc/tf32x3_gemm.cuh), their weights split once by
// the wrapper: rows 11 and 12's folded conv1 and row 7's conv1 (+ b1) as
// implicit GEMMs (conv_kernel: A read from one TMA halo box of the NHWC
// image a 32-channel slice, at each tap's shifted rows) on 128 x C2 tiles
// (two of 64 at C2 = 128, two of 96 at 192), conv2 with b2, ReLU, the 1x1,
// b3 and ReLU on 128 x 32 with the 1x1 on a pixel's 32 sums gathered into
// one thread of its quad, and row 7's out_conv mix as the dense product
// (gemm_kernel, 128 x 128 tiles). Each is one entry point, front and back
// together, so the f32 big-C tail's intermediate mid (B, HM, W2, C2) f32 is
// the front's post-conv1 product as at bf16. What bounds them: at vits'
// 1080p (B = 8) row 7's mix, conv1 and conv2 are 2.6 + 46 + 71 GFLOP, 0.72
// ms at 3xTF32's 165 TFLOP/s, against ~1.4 GB of f32 intermediates (0.42
// ms); at vitb-518 (C = 128) rows 11 and 12's conv1 and conv2 are 184 + 141
// GFLOP (1.97 ms) against ~4 GB of f32 U, mid and R written and read (1.2
// ms): bound by operations. Row 15 at f32 (vrvg_head_tail_f32) is row 7's
// f32 chain from conv1 on, on the same core (see its entry point).
//
// Widths. The JAX kernels take a head of any C with C2 = C / 2 a multiple
// of 8, the big-C tail C <= 128 or a multiple of 128 besides
// (head_tail_pallas.py:174, 395, 683-684). The kernels here read channels
// in fixed slices: at bf16 64 a K step of the core (the mix, conv1) and 16
// a k step of conv2's halo kernel, whose conv1 mode writes 32; at f32 32 a
// slice of the 3xTF32 conv. So each chain runs at widths (C, C2) those
// slices take (bf16_widths, f32_widths), and a head between them runs
// zero-padded to the next ones up (ops/head_tail.chain_widths): weight rows
// and columns and biases past the head's own widths are zeros, set once
// per weight by the wrapper (`cw` computed on the head's weights, its
// padded columns zeros), and the NCHW transpose writes x's padded channels
// as zeros. A product of a zero is an exact zero, and a sum of exact zeros
// adds nothing, so every intermediate's padded channels are exact zeros and
// every stage sum is that of the head's own channels: at f32 bit for bit
// the unpadded sums on the 3xTF32 core's fresh stage sums. The cost is the
// padded share of each pass's bytes and each conv's products (at C = 32,
// f32, half of conv2's products; at C = 16, bf16, the chain runs C = 64 and
// C2 = 32, so a quarter of x's, xoc's and Z's channels and of c1's and R's
// are the head's). The chains' conv1 tiles span N
// = C2 in 64 to 192 columns (conv1_core, conv3x3_f32), the last tile
// ragged where they do not divide it; the core's persistent walk takes any
// count of column tiles, so the big-C tail at C = 512-896 (C2 = 256-448)
// runs the same instantiations.

#include <type_traits>

#include "taps.cuh"
#include "tf32x3_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace vrvg;

constexpr int C3 = 32;           // output_conv2's width (reference head)
constexpr int PASS_THREADS = 256;

// ---------------------------------------------------------------------------
// Row 11, 0: the chains read x as (B, H0 W0, C), C the chain's width, to
// which a custom head's CIN channels are zero-padded (ops/head_tail
// .chain_widths). The model hands x over as an NCHW activation seen as NHWC:
// x (B, CIN, H0 W0) -> (B, H0 W0, C) in 64 x 64 tiles through shared
// memory, so a warp reads 64 pixels of a channel and writes 64 channels of
// a pixel, 128 bytes each way (256 for f32). A contiguous NHWC x narrower
// than its chain (off the model's path) is copied by the same kernel at its
// own strides (a channel 1 apart, a pixel CIN). Channels CIN to C are
// written as zeros, so the padding costs no pass of its own. T is bf16, or
// f32 for the f32 tails. C is even.
constexpr int TT = 64;  // transpose tile

template <class T>
struct Pair;  // two elements stored as one
template <>
struct Pair<bf16> {
  typedef __nv_bfloat162 type;
};
template <>
struct Pair<float> {
  typedef float2 type;
};

template <class T>
__global__ void __launch_bounds__(PASS_THREADS)
to_channels_last_kernel(const T* __restrict__ x, T* __restrict__ y, int cin,
                        int c, int hw, int cstride, int pstride) {
  __shared__ T t[TT][TT + 2];  // [channel][pixel]
  const int p0 = blockIdx.x * TT, c0 = blockIdx.y * TT, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* src = x + (long long)b * cin * hw;
  for (int ch = warp; ch < TT && c0 + ch < c; ch += PASS_THREADS / 32) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = 2 * lane + e;
      t[ch][p] = c0 + ch < cin && p0 + p < hw
                     ? src[(long long)(c0 + ch) * cstride +
                           (long long)(p0 + p) * pstride]
                     : from_f32<T>(0.f);
    }
  }
  __syncthreads();
  T* dst = y + ((long long)b * hw + p0) * c + c0;
  if (c0 + 2 * lane >= c) return;
  for (int p = warp; p < TT && p0 + p < hw; p += PASS_THREADS / 32) {
    typename Pair<T>::type v;
    v.x = t[2 * lane][p];
    v.y = t[2 * lane + 1][p];
    *reinterpret_cast<typename Pair<T>::type*>(dst + (long long)p * c +
                                               2 * lane) = v;
  }
}

// Row 11, 1: U (B, HM, W2, C) from x (B, H0, W0, C) contiguous. Block (HM
// row, frame), 16 bytes of U a thread (8 bf16 or 4 f32 channels). With BIAS
// (row 7's Z) the f32 bias is added to the H-lerp before its cast
// (head_tail_pallas.py:309-318, the out_conv bias).
template <class T, bool BIAS>
__global__ void __launch_bounds__(PASS_THREADS)
upsample_kernel(const T* __restrict__ x,         // (B, H0, W0, C)
                const int* __restrict__ taps,    // (2, W2) j0, j1
                const float* __restrict__ tapw,  // (2, W2) wa, wb
                const float* __restrict__ bias,  // (C,) with BIAS
                T* __restrict__ u,               // (B, HM, W2, C)
                int c, int h0, int w0, int hm, int w2) {
  constexpr int V = 16 / sizeof(T);  // channels a thread
  const int zr = blockIdx.x, b = blockIdx.y;
  const int groups = c / V;
  const Taps k = lerp_taps(zr, h0, hm);
  const T* r0 = x + ((long long)b * h0 + k.i0) * w0 * c;
  const T* r1 = x + ((long long)b * h0 + k.i1) * w0 * c;
  T* dst = u + ((long long)b * hm + zr) * w2 * c;
  for (int i = threadIdx.x; i < w2 * groups; i += PASS_THREADS) {
    const int col = i / groups, cg = (i - col * groups) * V;
    const int ja = taps[col] * c + cg, jb = taps[w2 + col] * c + cg;
    const float wa = tapw[col], wb = tapw[w2 + col];
    const uint4 a0 = *reinterpret_cast<const uint4*>(r0 + ja);
    const uint4 b0 = *reinterpret_cast<const uint4*>(r0 + jb);
    const uint4 a1 = *reinterpret_cast<const uint4*>(r1 + ja);
    const uint4 b1 = *reinterpret_cast<const uint4*>(r1 + jb);
    __align__(16) T z0[V], z1[V], v[V];
    wlerp<T, V>(z0, reinterpret_cast<const T*>(&a0),
                reinterpret_cast<const T*>(&b0), wa, wb);
    wlerp<T, V>(z1, reinterpret_cast<const T*>(&a1),
                reinterpret_cast<const T*>(&b1), wa, wb);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float f = lerp(k, to_f32(z0[e]), to_f32(z1[e]));
      v[e] = from_f32<T>(BIAS ? __fadd_rn(f, __ldg(bias + cg + e)) : f);
    }
    *reinterpret_cast<uint4*>(dst + (long long)i * V) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// ---------------------------------------------------------------------------
// Row 12, 1: R (B, H1, W1, C2) from mid (B, HM, W2, C2); row 7's R from its
// conv1 output c1 the same way, without `cw` (CW false).

// One row of the TPU's intermediate at HM row m, V = 16 / sizeof(T)
// channels: the two-tap W-resize of mid in f32, with CW + cw0 (at cw) and
// the top / bottom row corrections (`plane` and 2 `plane` floats on), ->
// T.
template <class T, bool CW>
__device__ __forceinline__ void mid_row(float* out, const T* row, int ja,
                                        int jb, float wa, float wb,
                                        const float* cw, long long plane,
                                        bool top, bool bot) {
  constexpr int V = 16 / sizeof(T);
  const uint4 ua = *reinterpret_cast<const uint4*>(row + ja);
  const uint4 ub = *reinterpret_cast<const uint4*>(row + jb);
  const T* a = reinterpret_cast<const T*>(&ua);
  const T* b = reinterpret_cast<const T*>(&ub);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float f = __fadd_rn(__fmul_rn(wa, to_f32(a[e])),
                        __fmul_rn(wb, to_f32(b[e])));
    if constexpr (CW) {
      f = __fadd_rn(f, cw[e]);
      if (top) f = __fadd_rn(f, cw[plane + e]);
      if (bot) f = __fadd_rn(f, cw[2 * plane + e]);
    }
    out[e] = to_f32(from_f32<T>(f));
  }
}

// Block (H1 row, frame), 16 bytes of R a thread.
template <class T, bool CW>
__global__ void __launch_bounds__(PASS_THREADS)
resize_kernel(const T* __restrict__ mid,       // (B, HM, W2, C2)
              const int* __restrict__ taps,    // (2, W1) j0, j1
              const float* __restrict__ tapw,  // (2, W1) wa, wb
              const float* __restrict__ cw,    // (3, W1, C2) cw0, dtop, dbot
              T* __restrict__ r,               // (B, H1, W1, C2)
              int c2, int hm, int w2, int h1, int w1) {
  constexpr int V = 16 / sizeof(T);
  const int row = blockIdx.x, b = blockIdx.y;
  const int groups = c2 / V;
  const long long plane = (long long)w1 * c2;
  const Taps k = lerp_taps(row, hm, h1);
  const T* m0 = mid + ((long long)b * hm + k.i0) * w2 * c2;
  const T* m1 = mid + ((long long)b * hm + k.i1) * w2 * c2;
  T* dst = r + ((long long)b * h1 + row) * w1 * c2;
  for (int i = threadIdx.x; i < w1 * groups; i += PASS_THREADS) {
    const int col = i / groups, cg = (i - col * groups) * V;
    const int ja = taps[col] * c2 + cg, jb = taps[w1 + col] * c2 + cg;
    const float wa = tapw[col], wb = tapw[w1 + col];
    const float* c0 = CW ? cw + (long long)i * V : nullptr;
    float z0[V], z1[V];
    mid_row<T, CW>(z0, m0, ja, jb, wa, wb, c0, plane, k.i0 == 0,
                   k.i0 == hm - 1);
    mid_row<T, CW>(z1, m1, ja, jb, wa, wb, c0, plane, k.i1 == 0,
                   k.i1 == hm - 1);
    __align__(16) T v[V];
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = from_f32<T>(lerp(k, z0[e], z1[e]));
    *reinterpret_cast<uint4*>(dst + (long long)i * V) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// ---------------------------------------------------------------------------
// Row 12, 2: conv2 + ReLU + 1x1 + ReLU on halo tiles of R; and row 7's conv1
// at 32 output channels.
namespace conv2 {

constexpr int TR = 2;                 // output rows a tile
constexpr int TW = 128;               // output pixels a tile row
constexpr int HALO_W = TW + 2;        // R's pixels a halo row
constexpr int MT = 2;  // m16 tiles (16 pixels) a warp (4: 1.05 ms against
                       // 0.95 at vitl-518 on an H100)
constexpr int WARP_PX = 16 * MT;      // a consumer warp's pixels of a row
constexpr int WARPS = TR * TW / WARP_PX;   // consumers
constexpr int THREADS = 32 * (WARPS + 1);  // + the producer warp
// A pixel of a 64-channel chunk is one 128-byte row of the 128-byte
// swizzle, in (row, pixel) order; the weights are rows tap * 32 + n of the
// chunk's 64 input channels, loaded as two boxes of 144 rows.
constexpr uint32_t HALO_BYTES = (TR + 2) * HALO_W * 128;  // 66560
constexpr int W_ROWS = 9 * C3;
constexpr uint32_t W_BYTES = W_ROWS * 128;                // 36864
constexpr uint32_t STAGE_BYTES = HALO_BYTES + W_BYTES;
constexpr int STAGES = 2;
constexpr uint32_t BAR_OFF = STAGES * STAGE_BYTES;
constexpr size_t SMEM_BYTES = BAR_OFF + 8 * 2 * STAGES + 1024;
static_assert(SMEM_BYTES <= tma_gemm::SMEM_LIMIT, "shared memory");
static_assert(HALO_BYTES % 1024 == 0 && W_BYTES % 2048 == 0, "alignment");

// The 16-byte unit `chunk` (8 channels) of 128-byte row `row` of a tile
// laid out by TMA in the 128-byte swizzle from `base` (1024-aligned).
__device__ __forceinline__ uint32_t swz(uint32_t base, int row, int chunk) {
  return base + row * 128 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, row-major) b (16 x 8, column-major).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// What the kernel makes of a pixel's 32 f32 sums: row 12's conv2, + b2,
// ReLU, the 1x1 (32 -> 1), + b3, ReLU -> f32 depth (B, H1, W1); or row 7's
// conv1 at 32 output channels, + b1 in f32, cast -> bf16 (B, H1, W1, 32).
struct DepthOut {};
struct Conv1Out {};

// For DepthOut, b2 is conv2's bias and w3, b3 the 1x1's; for Conv1Out b2 is
// conv1's bias b1 and w3, b3 are not read. (c2, h1, w1 name conv2's input
// width and grid; for conv1 they are C, HM and W2.)
template <class Out>
__global__ void __launch_bounds__(THREADS, 1)
conv2_kernel(const __grid_constant__ CUtensorMap tr,  // R (C2, W1, H1, B)
             const __grid_constant__ CUtensorMap tw,  // w (C2, 9 * 32)
             const float* __restrict__ b2,            // (32,)
             const float* __restrict__ w3,            // (32,)
             const float* __restrict__ b3,            // (1,)
             void* __restrict__ out,
             int batch, int h1, int w1, int c2) {
  constexpr bool DEPTH = std::is_same<Out, DepthOut>::value;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar_full = base + BAR_OFF;
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const int tiles_x = (w1 + TW - 1) / TW, tiles_y = (h1 + TR - 1) / TR;
  const int tiles = batch * tiles_y * tiles_x;
  const int chunks = (c2 + 63) / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == WARPS) {
    if (lane == 0) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int x0 = tile % tiles_x * TW;
        const int y0 = tile / tiles_x % tiles_y * TR;
        const int b = tile / (tiles_x * tiles_y);
        for (int ch = 0; ch < chunks; ++ch, ++it) {
          const uint32_t s = it % STAGES;
          const uint32_t sb = base + s * STAGE_BYTES;
          mbar_wait(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * s, STAGE_BYTES);
          tma_load_4d(sb, &tr, ch * 64, x0 - 1, y0 - 1, b, bar_full + 8 * s);
          tma_load_2d(sb + HALO_BYTES, &tw, ch * 64, 0, bar_full + 8 * s);
          tma_load_2d(sb + HALO_BYTES + W_BYTES / 2, &tw, ch * 64, W_ROWS / 2,
                      bar_full + 8 * s);
        }
      }
    }
    return;
  }

  // Consumer warp: output row y0 + rr, pixels x0 + px0 + [0, WARP_PX) as
  // MT m16 tiles; the accumulator of m16 tile mt, n8 tile nt holds pixels
  // g and g + 8 (g = lane / 4), channels 8 nt + 2 (lane % 4) + {0, 1}.
  const int rr = warp / (TW / WARP_PX);
  const int px0 = warp % (TW / WARP_PX) * WARP_PX;
  const int g = lane / 4, q = lane % 4;
  float bias[8], wout[8];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bias[2 * nt + e] = b2[8 * nt + 2 * q + e];
      wout[2 * nt + e] = DEPTH ? w3[8 * nt + 2 * q + e] : 0.f;
    }
  }
  const float bout = DEPTH ? b3[0] : 0.f;
  // ldmatrix rows of this lane: A pixel lane % 16 (+ 16 mt) at k half lane
  // / 16; B row n = 8 (lane / 16) + lane % 8 (+ 16 np) at k half (lane / 8)
  // % 2.
  const int a_px = px0 + lane % 16, a_half = lane / 16;
  const int b_n = 8 * (lane / 16) + lane % 8, b_half = (lane / 8) % 2;
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int x0 = tile % tiles_x * TW;
    const int y0 = tile / tiles_x % tiles_y * TR;
    const int b = tile / (tiles_x * tiles_y);
    float acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    for (int ch = 0; ch < chunks; ++ch, ++it) {
      const uint32_t s = it % STAGES;
      mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
      const uint32_t halo = base + s * STAGE_BYTES;
      const uint32_t wts = halo + HALO_BYTES;
      // 16-channel k steps of this chunk that hold channels < C2.
      const int ksteps = min(4, (c2 - ch * 64) / 16);
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int dh = tap / 3, dw = tap - 3 * dh;
        const int a_row = (rr + dh) * HALO_W + a_px + dw;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk >= ksteps) break;
          uint32_t bf_[2][4], af[MT][4];
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            ldmatrix_x4(bf_[np], swz(wts, tap * C3 + 16 * np + b_n,
                                     2 * kk + b_half));
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            ldmatrix_x4(af[mt], swz(halo, a_row + 16 * mt, 2 * kk + a_half));
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              mma_bf16(acc[mt][nt], af[mt], bf_[nt / 2][2 * (nt % 2)],
                       bf_[nt / 2][2 * (nt % 2) + 1]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }

    const int row = y0 + rr;
    if constexpr (!DEPTH) {
      // + b1, cast: a thread's two channels of each n8 tile as one word.
      bf16* c1 = static_cast<bf16*>(out);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = x0 + px0 + 16 * mt + 8 * h + g;
          if (row >= h1 || px >= w1) continue;
          bf16* dst = c1 + (((long long)b * h1 + row) * w1 + px) * C3 + 2 * q;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            *reinterpret_cast<uint32_t*>(dst + 8 * nt) = pack_bf16(
                __fadd_rn(acc[mt][nt][2 * h], bias[2 * nt]),
                __fadd_rn(acc[mt][nt][2 * h + 1], bias[2 * nt + 1]));
          }
        }
      }
      continue;
    }
    // + b2, ReLU, the 1x1 over this thread's 8 channels, the quad's sum,
    // + b3, ReLU.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float y =
                fmaxf(__fadd_rn(acc[mt][nt][2 * h + e], bias[2 * nt + e]), 0.f);
            sum = __fadd_rn(sum, __fmul_rn(y, wout[2 * nt + e]));
          }
        }
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
        const int px = x0 + px0 + 16 * mt + 8 * h + g;
        if (q == 0 && row < h1 && px < w1) {
          static_cast<float*>(out)[((long long)b * h1 + row) * w1 + px] =
              fmaxf(__fadd_rn(sum, bout), 0.f);
        }
      }
    }
  }
}

// The halo-tile kernel over `in` (B, H, W, C) bf16 with weights w (9 * 32,
// C) bf16, row (3 dh + dw) 32 + n, on `stream`. Returns a CUDA error code.
template <class Out>
int launch(const void* in, const void* w, const float* bias, const float* w3,
           const float* b3, void* out, int batch, int h, int width, int c,
           void* stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t px = (cuuint64_t)c * 2, row = px * width;
  CUtensorMap tr, tw;
  if (!tma_gemm::make_map<4>(
          encode, &tr, in,
          {(cuuint64_t)c, (cuuint64_t)width, (cuuint64_t)h, (cuuint64_t)batch},
          {px, row, row * h}, {64, HALO_W, TR + 2, 1}) ||
      !tma_gemm::make_map_2d(encode, &tw, w, W_ROWS, c, W_ROWS / 2, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(conv2_kernel<Out>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
  }
  if (err != cudaSuccess) return (int)err;
  const int tiles = batch * ((h + TR - 1) / TR) * ((width + TW - 1) / TW);
  conv2_kernel<Out><<<tiles < sms ? tiles : sms, THREADS, SMEM_BYTES,
                      (cudaStream_t)stream>>>(tr, tw, bias, w3, b3, out,
                                              batch, h, width, c);
  return (int)cudaGetLastError();
}

}  // namespace conv2

// Row 11, 0 on `stream`: x as the chain reads it, (B, H W, C) of elements T
// (bf16 unless named): x itself (layout 0, C = CIN), or x copied into the
// scratch xt with channels CIN to C zero, from an NCHW x seen as NHWC
// (layout 1) or a contiguous NHWC x (layout 2) of CIN channels. Returns a
// CUDA error code.
template <class T = bf16>
int channels_last(const void*& x, int layout, void* xt, int batch, int cin,
                  int c, int hw, void* stream) {
  if (layout == 0) return cin == c ? 0 : (int)cudaErrorInvalidValue;
  if (layout != 1 && layout != 2) return (int)cudaErrorInvalidValue;
  to_channels_last_kernel<T><<<dim3((hw + TT - 1) / TT, (c + TT - 1) / TT,
                                    batch),
                               PASS_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (T*)xt, cin, c, hw, layout == 1 ? hw : 1,
      layout == 1 ? 1 : cin);
  x = xt;
  return (int)cudaGetLastError();
}

// The widths a bf16 chain runs at: C, x's channels once channels_last has
// zero-padded a head's CIN to it, a multiple of 64 (the core's K slice: the
// mix and conv1 read 64-channel boxes); C2, conv1's outputs and conv2's
// inputs, a multiple of 16 (conv2's k step) and at least 32 (conv1's halo
// kernel writes 32 channels). ops/head_tail.chain_widths pads a head's C
// and C / 2 up to them.
inline bool bf16_widths(int cin, int c, int c2) {
  return cin > 0 && cin <= c && c % 64 == 0 && c2 >= 32 && c2 % 16 == 0;
}

// The widths an f32 chain runs at: C and C2 multiples of 32, the 3xTF32
// conv's channel slice (conv1 reads C, conv2 C2 in 32-channel slices).
inline bool f32_widths(int cin, int c, int c2) {
  return cin > 0 && cin <= c && c % 32 == 0 && c2 > 0 && c2 % 32 == 0;
}

// conv1 on the core (C -> n outputs, epi its epilogue): 256 x 64 tiles where
// `narrow` (row 15 at n <= 64, rows 7 and 11 at n < 64), 128 x 192 where
// they cover n exactly, else 256 x 128, the last ragged (TMA leaves its
// columns past n unstored).
template <class Epi>
int conv1_core(const void* u, const void* w, void* out, int batch, int h,
               int width, int c, int n, const Epi& epi, bool narrow,
               void* stream) {
  if (narrow) {
    return tma_gemm::conv3x3<tma_gemm::Tile<256, 64>>(u, w, out, batch, h,
                                                      width, c, n, epi,
                                                      stream);
  }
  if (n % 192 == 0) {
    return tma_gemm::conv3x3<tma_gemm::Tile<128, 192>>(u, w, out, batch, h,
                                                       width, c, n, epi,
                                                       stream);
  }
  return tma_gemm::conv3x3<tma_gemm::Tile<256, 128>>(u, w, out, batch, h,
                                                     width, c, n, epi,
                                                     stream);
}

// Row 12 (and the back of rows 7 and 15 with a null `cw`): the resize pass
// into r, then conv2 with the 1x1 into out. Returns a CUDA error code.
int back(const void* mid, const void* taps, const void* tapw, const void* cw,
         const void* w2m, const void* b2, const void* w3, const void* b3,
         void* r, void* out, int batch, int hm, int w2, int c2, int h1,
         int w1, void* stream) {
  const dim3 grid(h1, batch);
  const cudaStream_t st = (cudaStream_t)stream;
  if (cw != nullptr) {
    resize_kernel<bf16, true><<<grid, PASS_THREADS, 0, st>>>(
        (const bf16*)mid, (const int*)taps, (const float*)tapw,
        (const float*)cw, (bf16*)r, c2, hm, w2, h1, w1);
  } else {
    resize_kernel<bf16, false><<<grid, PASS_THREADS, 0, st>>>(
        (const bf16*)mid, (const int*)taps, (const float*)tapw, nullptr,
        (bf16*)r, c2, hm, w2, h1, w1);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return conv2::launch<conv2::DepthOut>(r, w2m, (const float*)b2,
                                        (const float*)w3, (const float*)b3,
                                        out, batch, h1, w1, c2, stream);
}

}  // namespace

namespace vrvg {
// csrc/head_tail.cu: the single-kernel tail at C = 32 on the wmma chain.
int head_tail_wmma(const void* x, int batch, int h2, int w2, const void* wt1,
                   const void* b1, const void* wt2, const void* b2,
                   const void* w3, const void* b3, const void* taps,
                   const void* tapw, void* c1, void* out, int h1, int w1,
                   void* stream);
}  // namespace vrvg

// The x arguments of every entry point below: x (B, H, W, CIN) as
// channels_last takes it (`layout`; for layouts 1 and 2 the scratch xt (B,
// H, W, C)), C the chain's width (CIN zero-padded) and C2 its conv1 output
// width, which the weights are laid out for: rows and columns past a head's
// own widths (CIN, CIN / 2) zeros, so the padded channels of every
// intermediate are exact zeros and each sum is that of the head's own
// channels (ops/head_tail.chain_widths, .pad_to).

// Row 11. x; conv1 with out_conv's mix folded in, as the GEMM's B (C2, 9 C)
// bf16, k = (3 dh + dw) C + c; W-upsample tap tables (2, 2 W0) int32 / f32;
// scratch u (B, 2 H0, 2 W0, C) bf16 -> mid (B, 2 H0, 2 W0, C2) bf16. C, C2
// as bf16_widths takes them (vitl's 256, 128; vitg's 384, 192).
extern "C" int vrvg_head_tail_big_front(const void* x, int layout, void* xt,
                                        const void* w1m, const void* taps,
                                        const void* tapw, void* u, void* mid,
                                        int batch, int h0, int w0, int cin,
                                        int c, int c2, void* stream) {
  if (!bf16_widths(cin, c, c2)) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || h0 <= 0 || w0 <= 0) return (int)cudaSuccess;
  const int hm = 2 * h0, w2 = 2 * w0;
  int err = channels_last(x, layout, xt, batch, cin, c, h0 * w0, stream);
  if (err != 0) return err;
  upsample_kernel<bf16, false><<<dim3(hm, batch), PASS_THREADS, 0,
                                 (cudaStream_t)stream>>>(
      (const bf16*)x, (const int*)taps, (const float*)tapw, nullptr,
      (bf16*)u, c, h0, w0, hm, w2);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return conv1_core(u, w1m, mid, batch, hm, w2, c, c2,
                    tma_gemm::Identity{nullptr}, c2 < 64, stream);
}

// Row 12. mid (B, HM, W2, C2) bf16; W-resize tap tables (2, W1); cw (3, W1,
// C2) f32 (cw0, cw1 - cw0, cw2 - cw0), or null for row 7's back (no `cw`);
// conv2 as (9 * 32, C2) bf16, row (3 dh + dw) 32 + n; b2 (32,), the 1x1
// (32,) and its bias (1,) f32; scratch r (B, H1, W1, C2) bf16 -> out (B, H1,
// W1) f32. C2 as bf16_widths takes it.
extern "C" int vrvg_head_tail_big_back(const void* mid, const void* taps,
                                       const void* tapw, const void* cw,
                                       const void* w2m, const void* b2,
                                       const void* w3, const void* b3,
                                       void* r, void* out, int batch, int hm,
                                       int w2, int c2, int h1, int w1,
                                       void* stream) {
  if (!bf16_widths(64, 64, c2)) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || h1 <= 0 || w1 <= 0) return (int)cudaSuccess;
  return back(mid, taps, tapw, cw, w2m, b2, w3, b3, r, out, batch, hm, w2, c2,
              h1, w1, stream);
}

// Row 7's front. x; out_conv (C out, C in) bf16 + (C,) f32 bias; W-upsample
// tap tables (2, 2 W0); conv1 + (C2,) f32 bias, as (C2, 9 C) bf16 with k =
// (3 dh + dw) C + c (the GEMM's B) where C2 > 32, as (9 * 32, C) with row
// (3 dh + dw) 32 + n (the halo kernel's) at C2 = 32; scratch xoc (B, H0,
// W0, C) and z (B, 2 H0, 2 W0, C) bf16 -> c1 (B, 2 H0, 2 W0, C2) bf16. C, C2
// as bf16_widths takes them.
extern "C" int vrvg_head_tail_ext_front(
    const void* x, int layout, void* xt, const void* koc, const void* boc,
    const void* taps, const void* tapw, void* xoc, void* z, const void* w1,
    const void* b1, void* c1, int batch, int h0, int w0, int cin, int c,
    int c2, void* stream) {
  if (!bf16_widths(cin, c, c2)) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || h0 <= 0 || w0 <= 0) return (int)cudaSuccess;
  const int hm = 2 * h0, w2 = 2 * w0;
  int err = channels_last(x, layout, xt, batch, cin, c, h0 * w0, stream);
  if (err != 0) return err;
  // The out_conv mix per input pixel: a (B H0 W0, C) x (C, C)^T product.
  const tma_gemm::Identity mix{nullptr};
  err = c % 192 == 0
            ? tma_gemm::gemm<tma_gemm::Tile<128, 192>>(x, koc, xoc,
                                                       batch * h0 * w0, c, c,
                                                       mix, stream)
            : tma_gemm::gemm<tma_gemm::Tile<256, 128>>(x, koc, xoc,
                                                       batch * h0 * w0, c, c,
                                                       mix, stream);
  if (err != 0) return err;
  upsample_kernel<bf16, true><<<dim3(hm, batch), PASS_THREADS, 0,
                                (cudaStream_t)stream>>>(
      (const bf16*)xoc, (const int*)taps, (const float*)tapw,
      (const float*)boc, (bf16*)z, c, h0, w0, hm, w2);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (c2 == 32) {
    return conv2::launch<conv2::Conv1Out>(z, w1, (const float*)b1, nullptr,
                                          nullptr, c1, batch, hm, w2, c,
                                          stream);
  }
  return conv1_core(z, w1, c1, batch, hm, w2, c, c2,
                    tma_gemm::BiasBeforeCast{nullptr, (const float*)b1},
                    c2 < 64, stream);
}

// Row 15, the single-kernel tail. x = path1 (B, H2, W2, CIN); conv1 (C2, C,
// 3, 3) + (C2,) f32 bias as k1 in the layout of its kernel: at C = 32 (a
// head of 32 features, CIN = 32, C2 = 16) (3, 3, C, C2) for the wmma chain
// (path1 contiguous, layout 0); at C2 = 32 (9 * 32, C) with row (3 dh + dw)
// 32 + n (the halo kernel); otherwise (C2, 9 C) with k = (3 dh + dw) C + c
// (the GEMM's B); conv2 as k2, (3, 3, C2, 32) at C = 32 and (9 * 32, C2)
// otherwise; b2 (32,), the 1x1 (32,) and b3 (1,) f32; the W-resize tap
// tables (2, W1); scratch c1 (B, H2, W2, C2) and r (B, H1, W1, C2) bf16 (r
// not read at C = 32) -> out (B, H1, W1) f32. C, C2 as bf16_widths takes
// them, or 32, 16.
extern "C" int vrvg_head_tail(const void* x, int layout, void* xt,
                              const void* k1, const void* b1, const void* k2,
                              const void* b2, const void* w3, const void* b3,
                              const void* taps, const void* tapw, void* c1,
                              void* r, void* out, int batch, int h2, int w2,
                              int cin, int c, int c2, int h1, int w1,
                              void* stream) {
  const bool wmma = cin == 32 && c == 32 && c2 == 16 && layout == 0;
  if (!wmma && !bf16_widths(cin, c, c2)) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || h2 <= 0 || w2 <= 0 || h1 <= 0 || w1 <= 0) {
    return (int)cudaSuccess;
  }
  if (wmma) {
    return head_tail_wmma(x, batch, h2, w2, k1, b1, k2, b2, w3, b3, taps,
                          tapw, c1, out, h1, w1, stream);
  }
  int err = channels_last(x, layout, xt, batch, cin, c, h2 * w2, stream);
  if (err != 0) return err;
  if (c2 == 32) {
    err = conv2::launch<conv2::Conv1Out>(x, k1, (const float*)b1, nullptr,
                                         nullptr, c1, batch, h2, w2, c,
                                         stream);
  } else {
    err = conv1_core(x, k1, c1, batch, h2, w2, c, c2,
                     tma_gemm::BiasBeforeCast{nullptr, (const float*)b1},
                     c2 <= 64, stream);
  }
  if (err != 0) return err;
  return back(c1, taps, tapw, nullptr, k2, b2, w3, b3, r, out, batch, h2, w2,
              c2, h1, w1, stream);
}

namespace {

// epi on the (B H W, n) f32 sums of a 3x3 conv with zero padding of x (B,
// H, W, C) f32 on the 3xTF32 core, the weights (n, 9 C) split; n = epi.n a
// multiple of 32, on tiles of 96 where they cover n (two at 192), of 32 at
// n = 32, else of 64, the last ragged where 64 does not divide n (its
// columns past n are not stored).
template <class Epi>
int conv3x3_f32(const float* x, const uint32_t* ws, int batch, int h, int w,
                int c, const Epi& epi, void* stream) {
  const int n = epi.n;
  if (n <= 0 || n % 32) return (int)cudaErrorInvalidValue;
  if (n % 96 == 0) {
    return tf32x3_gemm::conv3x3<96>(x, ws, batch, h, w, c, n, epi, stream);
  }
  if (n == 32) {
    return tf32x3_gemm::conv3x3<32>(x, ws, batch, h, w, c, 32, epi, stream);
  }
  return tf32x3_gemm::conv3x3<64>(x, ws, batch, h, w, c, n, epi, stream);
}

}  // namespace

// Row 7 at f32 (the whole chain, front and back). x f32 (as the bf16
// entry points take it); out_conv (C out, C in) f32 given as
// its TF32 split (vrvg_tf32x3_split: (2, 128 ceil(C / 128), C)), + (C,) f32
// bias; the f32 W-upsample tap tables (2, 2 W0); conv1 as (C2, 9 C) f32
// with k = (3 dh + dw) C + c, split ((2, 128 ceil(C2 / 128), 9 C)), + (C2,)
// f32 bias; the f32 W-resize tap tables (2, W1); conv2 as (32, 9 C2) in the
// same k order, split ((2, 128, 9 C2)), b2 (32,), the 1x1 (32,) and b3
// (1,) f32; scratch xoc (B, H0, W0, C), z (B, 2 H0, 2 W0, C), c1 (B, 2 H0,
// 2 W0, C2) and r (B, H1, W1, C2) f32 -> out (B, H1, W1) f32. C, C2 as
// f32_widths takes them. The mix on the dense 3xTF32 product
// (128 x 128 tiles: at C = 64 half of each idle; a fresh tensor-core sum
// every 16 of K, which keeps it as close to the f64 mix on average as
// cuBLAS's SGEMM at K = 64), conv1 + b1 (BiasStore) and conv2 with the 1x1
// (DepthOut) on its conv, as rows 11 and 12 at f32 run theirs.
// Returns a CUDA error code (a tensor map that does not encode:
// cudaErrorInvalidValue).
extern "C" int vrvg_head_tail_ext_f32(
    const void* x, int layout, void* xt, const void* kocs, const void* boc,
    const void* taps_a, const void* tapw_a, void* xoc, void* z,
    const void* w1s, const void* b1, void* c1, const void* taps_b,
    const void* tapw_b, void* r, const void* w2s, const void* b2,
    const void* w3, const void* b3, void* out, int batch, int h0, int w0,
    int cin, int c, int c2, int h1, int w1, void* stream) {
  if (!f32_widths(cin, c, c2)) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || h0 <= 0 || w0 <= 0 || h1 <= 0 || w1 <= 0) {
    return (int)cudaSuccess;
  }
  const int hm = 2 * h0, w2 = 2 * w0;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = channels_last<float>(x, layout, xt, batch, cin, c, h0 * w0,
                                 stream);
  if (err != 0) return err;
  // The mix's K (C) is short: a fresh tensor-core sum every 16 of it.
  err = tf32x3_gemm::gemm<tf32x3_gemm::Store, 16>(
      (const float*)x, (const uint32_t*)kocs, batch * h0 * w0, c, c, 0,
      tf32x3_gemm::Store{c, (float*)xoc}, stream);
  if (err != 0) return err;
  upsample_kernel<float, true><<<dim3(hm, batch), PASS_THREADS, 0, st>>>(
      (const float*)xoc, (const int*)taps_a, (const float*)tapw_a,
      (const float*)boc, (float*)z, c, h0, w0, hm, w2);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = conv3x3_f32((const float*)z, (const uint32_t*)w1s, batch, hm, w2, c,
                    tf32x3_gemm::BiasStore{c2, (float*)c1, (const float*)b1},
                    stream);
  if (err != 0) return err;
  resize_kernel<float, false><<<dim3(h1, batch), PASS_THREADS, 0, st>>>(
      (const float*)c1, (const int*)taps_b, (const float*)tapw_b, nullptr,
      (float*)r, c2, hm, w2, h1, w1);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return tf32x3_gemm::conv3x3<C3>(
      (const float*)r, (const uint32_t*)w2s, batch, h1, w1, c2, C3,
      tf32x3_gemm::DepthOut{C3, (float*)out, (const float*)b2,
                            (const float*)w3, (const float*)b3},
      stream);
}

// Rows 11 and 12 at f32 (the big-C tail, front and back in one chain). x
// f32 (as the bf16 entry points take it); conv1 with out_conv's mix
// folded in (f32, ops/head_tail.fold_conv1) as (C2, 9 C), k = (3 dh + dw) C
// + c, given as its TF32 split (vrvg_tf32x3_split: (2, 128 ceil(C2 / 128),
// 9 C)); the f32 W-upsample tap tables (2, 2 W0); the f32 W-resize tap
// tables (2, W1) and cw (3, W1, C2) f32 (cw0, cw1 - cw0, cw2 - cw0); conv2
// as (32, 9 C2) in the same k order, split ((2, 128, 9 C2)), b2 (32,), the
// 1x1 (32,) and b3 (1,) f32; scratch u (B, 2 H0, 2 W0, C), mid (B, 2 H0,
// 2 W0, C2) and r (B, H1, W1, C2) f32 -> out (B, H1, W1) f32. C, C2 as
// f32_widths takes them. Returns a CUDA error code (a tensor map that does
// not encode: cudaErrorInvalidValue).
extern "C" int vrvg_head_tail_big_f32(
    const void* x, int layout, void* xt, const void* w1s, const void* taps_a,
    const void* tapw_a, void* u, void* mid, const void* taps_b,
    const void* tapw_b, const void* cw, void* r, const void* w2s,
    const void* b2, const void* w3, const void* b3, void* out, int batch,
    int h0, int w0, int cin, int c, int c2, int h1, int w1, void* stream) {
  if (!f32_widths(cin, c, c2)) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || h0 <= 0 || w0 <= 0 || h1 <= 0 || w1 <= 0) {
    return (int)cudaSuccess;
  }
  const int hm = 2 * h0, w2 = 2 * w0;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = channels_last<float>(x, layout, xt, batch, cin, c, h0 * w0,
                                 stream);
  if (err != 0) return err;
  upsample_kernel<float, false><<<dim3(hm, batch), PASS_THREADS, 0, st>>>(
      (const float*)x, (const int*)taps_a, (const float*)tapw_a, nullptr,
      (float*)u, c, h0, w0, hm, w2);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = conv3x3_f32((const float*)u, (const uint32_t*)w1s, batch, hm, w2, c,
                    tf32x3_gemm::Store{c2, (float*)mid}, stream);
  if (err != 0) return err;
  resize_kernel<float, true><<<dim3(h1, batch), PASS_THREADS, 0, st>>>(
      (const float*)mid, (const int*)taps_b, (const float*)tapw_b,
      (const float*)cw, (float*)r, c2, hm, w2, h1, w1);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return tf32x3_gemm::conv3x3<C3>(
      (const float*)r, (const uint32_t*)w2s, batch, h1, w1, c2, C3,
      tf32x3_gemm::DepthOut{C3, (float*)out, (const float*)b2,
                            (const float*)w3, (const float*)b3},
      stream);
}

// A 3x3 conv's f32 sums alone on the 3xTF32 core, as rows 11 and 12 at f32
// run their convs (no CLI path calls this: it exposes conv2's sums before
// the 1x1, for a check of the product): x (B, H, W, C) f32, contiguous, the
// weights (n, 9 C), k = (3 dh + dw) C + c, given as their TF32 split -> out
// (B, H, W, n) f32. C and n multiples of 32. Returns a CUDA error code.
extern "C" int vrvg_conv3x3_f32(const void* x, const void* ws, void* out,
                                int batch, int h, int w, int c, int n,
                                void* stream) {
  return conv3x3_f32((const float*)x, (const uint32_t*)ws, batch, h, w, c,
                     tf32x3_gemm::Store{n, (float*)out}, stream);
}

// Row 15 at f32 (the single-kernel tail, vrvg_head_tail at the f32 rounding
// points of `_tail_kernel`): x = path1 f32 (as the bf16 entry points take
// it); conv1 as (C2, 9 C) f32, k = (3 dh + dw) C + c, given as its TF32 split
// (vrvg_tf32x3_split: (2, 128, 9 C)), + (C2,) f32 bias on its f32 sums; the
// f32 W-resize tap tables (2, W1); conv2 as (32, 9 C2) in the same k order,
// split ((2, 128, 9 C2)), b2 (32,), the 1x1 (32,) and b3 (1,) f32; scratch
// c1 (B, H2, W2, C2) and r (B, H1, W1, C2) f32 -> out (B, H1, W1) f32. C,
// C2 as f32_widths takes them. Row 7's
// f32 chain from conv1 on: conv1 + b1 (BiasStore) on conv_kernel<C2>, the
// resize pass, conv2 with the 1x1 (DepthOut) on conv_kernel<32>. What
// bounds it: at vits' 1080p grid (B = 8, path1 296 x 528 x 64, depth 518 x
// 924) conv1 and conv2 are 46 + 71 GFLOP (0.71 ms at 3xTF32's 165
// TFLOP/s), at vitb's C = 128 184 + 141 (1.97 ms), against 0.8-1.4 GB of
// f32 path1, c1 and R: bound by operations; at C = 32 11.5 + 35 GFLOP
// (0.28 ms) against ~1.5 GB of the f32 path1 and the padded c1 and R
// written and read (0.44 ms at 3.35 TB/s): bound by bytes. Returns a CUDA
// error code (a tensor map that does not encode: cudaErrorInvalidValue).
extern "C" int vrvg_head_tail_f32(const void* x, int layout, void* xt,
                                  const void* w1s, const void* b1,
                                  const void* w2s, const void* b2,
                                  const void* w3, const void* b3,
                                  const void* taps, const void* tapw,
                                  void* c1, void* r, void* out, int batch,
                                  int h2, int w2, int cin, int c, int c2,
                                  int h1, int w1, void* stream) {
  if (!f32_widths(cin, c, c2)) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || h2 <= 0 || w2 <= 0 || h1 <= 0 || w1 <= 0) {
    return (int)cudaSuccess;
  }
  int err = channels_last<float>(x, layout, xt, batch, cin, c, h2 * w2,
                                 stream);
  if (err != 0) return err;
  err = conv3x3_f32((const float*)x, (const uint32_t*)w1s, batch, h2, w2,
                        c, tf32x3_gemm::BiasStore{c2, (float*)c1,
                                                  (const float*)b1},
                        stream);
  if (err != 0) return err;
  resize_kernel<float, false><<<dim3(h1, batch), PASS_THREADS, 0,
                                (cudaStream_t)stream>>>(
      (const float*)c1, (const int*)taps, (const float*)tapw, nullptr,
      (float*)r, c2, h2, w2, h1, w1);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return tf32x3_gemm::conv3x3<C3>(
      (const float*)r, (const uint32_t*)w2s, batch, h1, w1, c2, C3,
      tf32x3_gemm::DepthOut{C3, (float*)out, (const float*)b2,
                            (const float*)w3, (const float*)b3},
      stream);
}
