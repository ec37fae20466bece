// The big-C DPT tail (vitl C = 256, vitg C = 384) from refinenet1's
// pre-upsample activation to depth, for Hopper (sm_90a), as two kernels:
//
//   front: the x2 align-corners W-upsample of x -> bf16, the x2 H-upsample
//          (f32 lerp) -> bf16, zero outside the image, then output_conv1
//          3x3 (C -> C/2) with out_conv's 1x1 mix folded into its weights,
//          as an implicit GEMM, f32 sums -> bf16                  (HM, W2)
//   back:  the W-resize to the net width (two taps, f32) + out_conv's bias
//          response `cw` (interior / top / bottom row) -> bf16, the H-resize
//          (f32 lerp) -> bf16, zero outside, output_conv2 3x3 (C/2 -> 32) as
//          an implicit GEMM + f32 bias, ReLU, the 1x1 (32 -> 1) summed in f32
//          + bias, ReLU -> f32 depth                               (H1, W1)
//
// Replaces: vr_video_generator_tpu/ops/head_tail_pallas.py
// `head_tail_big_pallas`: row 11 `_big_front_kernel` and row 12
// `_big_back_kernel`, at their rounding points. The TPU's front also applies
// the W-resize and `cw` and keeps a (B, HM, C2, W1P) bf16 intermediate in
// HBM; here the front stores the post-conv1 product (B, HM, W2, C2) bf16
// instead (its bf16 cast is the same rounding point), and the back applies
// the W-resize and `cw` as it loads, rounding to bf16 before the H-resize as
// the TPU's intermediate does. The W-resizes have two non-zero taps per
// output, so fl(wa * a + wb * b) from per-column tap tables (bf16-rounded
// weights) is what the TPU's dense resize GEMM gives. `cw` is computed by the
// wrapper (ops/head_tail.py) in f32 as the JAX package computes it, and added
// as (z + cw0) + top * (cw1 - cw0) + bot * (cw2 - cw0).
//
// What bounds it on the H100: at 1080p/vitl (B = 8, 148 x 264 x 256 in, conv1
// at 296 x 528 x (256 -> 128), conv2 at 518 x 924 x (128 -> 32)) the two
// convolutions are 737 + 282 GFLOP (1.03 ms at the 989 TFLOP/s bf16 peak)
// against ~160 MB in, a 320 MB intermediate out and back, and 15 MB of depth:
// compute-bound. Each kernel is one block of 8 warps per 128-pixel segment of
// one output row; the block walks the input channels in chunks of 32: it
// builds the chunk's 3 rows x 130 pixels, resizing as it loads, and stages
// the chunk's 9 x 32 x COUT weights (the front's full 9 x 256 x 128 weights,
// 590 KB, do not fit in shared memory; a chunk is 74 KB), then each warp
// accumulates its 16 pixels x COUT on the tensor cores (nvcuda::wmma, bf16
// in, f32 accumulate). 111 KB of shared memory for the front, so two blocks
// share an SM. At vitg (C = 384, conv1 384 -> 192: 1.66 TFLOP at 1080p, B =
// 8, bound 1.68 ms; conv2 192 -> 32: 0.42 TFLOP, 0.43 ms) the front makes two
// passes of 96 output channels (FRONT_CP): 128 registers with a 4-byte
// spill, 93 KB of shared memory. Simple first: no pipelining, the weights
// re-read from L2 by every block, wmma and not wgmma.

#include "gemm.cuh"
#include "taps.cuh"

namespace {

using namespace vrvg;

constexpr int THREADS = 256;
constexpr int NW = THREADS / WARP;
constexpr int SEG = NW * 16;   // output pixels of one row per block
constexpr int KC = 32;         // input channels per chunk
constexpr int LDI = KC + 16;   // bf16 pitch of a staged input pixel
constexpr int C3 = 32;         // output_conv2's width (reference head)
constexpr int ITEMS = 3 * (SEG + 2) * (KC / 8);  // 8-channel groups per chunk

constexpr size_t IN_BYTES = align128((size_t)3 * (SEG + 2) * LDI * 2);

template <int COUT>
__host__ __device__ constexpr size_t conv_smem() {
  return IN_BYTES + align128((size_t)9 * KC * COUT * 2);
}

// The staged item i of a chunk: input row dh (0..2), pixel p (0..SEG+1),
// channel group c (0, 8, ...).
struct Item {
  int dh, p, c;
};

__device__ __forceinline__ Item item(int i) {
  Item it;
  it.dh = i / ((SEG + 2) * (KC / 8));
  const int rem = i % ((SEG + 2) * (KC / 8));
  it.p = rem / (KC / 8);
  it.c = (rem % (KC / 8)) * 8;
  return it;
}

// acc += the 3x3 convolution of the staged chunk: warp w's 16 pixels x COUT.
template <int COUT>
__device__ __forceinline__ void conv_chunk(FragC (&acc)[1][COUT / 16],
                                           const bf16* In, const bf16* Wt,
                                           int warp) {
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3, dw = tap % 3;
    const bf16* a = In + (dh * (SEG + 2) + warp * 16 + dw) * LDI;
    const bf16* wt = Wt + tap * KC * COUT;
#pragma unroll
    for (int k = 0; k < KC; k += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, a + k, LDI);
#pragma unroll
      for (int j = 0; j < COUT / 16; ++j) {
        FragBr fb;
        wmma::load_matrix_sync(fb, wt + k * COUT + j * 16, COUT);
        wmma::mma_sync(acc[0][j], fa, fb, acc[0][j]);
      }
    }
  }
}

// Stage each warp's accumulators (16 x COUT f32) in shared memory, over the
// input and weight buffers, which are free once every warp is done.
template <int COUT>
__device__ __forceinline__ float* stage(unsigned char* smem,
                                        const FragC (&acc)[1][COUT / 16],
                                        int warp) {
  static_assert((size_t)NW * 16 * COUT * 4 <= conv_smem<COUT>(), "staging");
  __syncthreads();
  float* st = reinterpret_cast<float*>(smem) + warp * 16 * COUT;
#pragma unroll
  for (int j = 0; j < COUT / 16; ++j)
    wmma::store_matrix_sync(st + j * 16, acc[0][j], COUT, wmma::mem_row_major);
  __syncwarp();
  return st;
}

// ---------------------------------------------------------------------------
// Row 11, front: W/H x2 upsample + folded conv1 -> bf16 mid. Grid (segments
// of W2, HM rows, frames). The output channels are computed CP at a time,
// each pass walking all input chunks: at C2 = 192 a warp's 16 x 192 f32
// accumulator would be 96 registers a lane and a chunk's weights 111 KB, so
// two passes of 96 (48 registers, 55 KB) restage the upsampled input once
// more instead.

template <int C2>
constexpr int FRONT_CP = C2 <= 128 ? C2 : C2 / 2;

template <int C, int C2>
__global__ void __launch_bounds__(THREADS, 2)
big_front_kernel(const bf16* __restrict__ x,     // (B, H0, W0, C)
                 const bf16* __restrict__ wt1,   // (9, C, C2) folded
                 const int* __restrict__ taps,   // (2, W2) j0, j1
                 const float* __restrict__ tapw, // (2, W2) wa, wb
                 bf16* __restrict__ mid,         // (B, HM, W2, C2)
                 int h0n, int w0n, int hm, int w2) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* In = reinterpret_cast<bf16*>(smem);
  bf16* Wt = reinterpret_cast<bf16*>(smem + IN_BYTES);
  const int x0 = blockIdx.x * SEG, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / WARP, lane = tid % WARP;
  const bf16* xb = x + (long long)b * h0n * w0n * C;

  constexpr int CP = FRONT_CP<C2>;
  FragC acc[1][CP / 16];
#pragma unroll 1
  for (int p0 = 0; p0 < C2; p0 += CP) {
    zero(acc);
#pragma unroll 1
    for (int kc = 0; kc < C; kc += KC) {
      __syncthreads();  // the previous chunk (or pass) fully consumed
      for (int i = tid; i < ITEMS; i += THREADS) {
        const Item it = item(i);
        const int zr = g - 1 + it.dh, col = x0 - 1 + it.p;
        __align__(16) bf16 v[8];
        if (zr >= 0 && zr < hm && col >= 0 && col < w2) {
          const Taps k = lerp_taps(zr, h0n, hm);
          const int ja = taps[col], jb = taps[w2 + col];
          const float wa = tapw[col], wb = tapw[w2 + col];
          const bf16* r0 = xb + (long long)k.i0 * w0n * C + kc + it.c;
          const bf16* r1 = xb + (long long)k.i1 * w0n * C + kc + it.c;
          const uint4 a0 = *reinterpret_cast<const uint4*>(r0 + (long long)ja * C);
          const uint4 b0 = *reinterpret_cast<const uint4*>(r0 + (long long)jb * C);
          const uint4 a1 = *reinterpret_cast<const uint4*>(r1 + (long long)ja * C);
          const uint4 b1 = *reinterpret_cast<const uint4*>(r1 + (long long)jb * C);
          __align__(16) bf16 z0[8], z1[8];
          wlerp8(z0, reinterpret_cast<const bf16*>(&a0),
                 reinterpret_cast<const bf16*>(&b0), wa, wb);
          wlerp8(z1, reinterpret_cast<const bf16*>(&a1),
                 reinterpret_cast<const bf16*>(&b1), wa, wb);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = rbf(lerp(k, bf(z0[e]), bf(z1[e])));
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = rbf(0.f);
        }
        *reinterpret_cast<uint4*>(In + (it.dh * (SEG + 2) + it.p) * LDI + it.c) =
            *reinterpret_cast<const uint4*>(v);
      }
      load_taps(Wt, wt1 + p0, C2, C, kc, KC, CP);
      __syncthreads();
      conv_chunk<CP>(acc, In, Wt, warp);
    }

    const float* st = stage<CP>(smem, acc, warp);
    bf16* dst = mid + ((long long)b * hm + g) * w2 * C2 + p0;
    for (int e = lane * 8; e < 16 * CP; e += WARP * 8) {
      const int r = e / CP, c = e % CP;
      const int px = x0 + warp * 16 + r;
      if (px >= w2) continue;
      __align__(16) bf16 v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = rbf(st[e + q]);
      *reinterpret_cast<uint4*>(dst + (long long)px * C2 + c) =
          *reinterpret_cast<const uint4*>(v);
    }
  }
}

// ---------------------------------------------------------------------------
// Row 12, back: W-resize + cw -> bf16, H-resize -> bf16, conv2 + ReLU + 1x1
// + ReLU -> f32 depth. Grid (segments of W1, H1 rows, frames).

// One row of the TPU's intermediate at HM row m, 8 channels: the two-tap
// W-resize of mid in f32, + cw0, + the top / bottom row correction, -> bf16.
__device__ __forceinline__ void mid_row8(float* out, const bf16* row, int ja,
                                         int jb, float wa, float wb, int c2,
                                         const float* cw0, const float* dtop,
                                         const float* dbot, bool top,
                                         bool bot) {
  const uint4 ua = *reinterpret_cast<const uint4*>(row + (long long)ja * c2);
  const uint4 ub = *reinterpret_cast<const uint4*>(row + (long long)jb * c2);
  const bf16* a = reinterpret_cast<const bf16*>(&ua);
  const bf16* b = reinterpret_cast<const bf16*>(&ub);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float f = __fadd_rn(__fadd_rn(__fmul_rn(wa, bf(a[e])),
                                  __fmul_rn(wb, bf(b[e]))), cw0[e]);
    if (top) f = __fadd_rn(f, dtop[e]);
    if (bot) f = __fadd_rn(f, dbot[e]);
    out[e] = bf(rbf(f));
  }
}

template <int C2>
__global__ void __launch_bounds__(THREADS, 2)
big_back_kernel(const bf16* __restrict__ mid,    // (B, HM, W2, C2)
                const int* __restrict__ taps,    // (2, W1) j0, j1
                const float* __restrict__ tapw,  // (2, W1) wa, wb
                const float* __restrict__ cw,    // (3, W1, C2) cw0, dtop, dbot
                const bf16* __restrict__ wt2,    // (9, C2, C3)
                const float* __restrict__ b2, const float* __restrict__ w3,
                const float* __restrict__ b3, float* __restrict__ out, int hm,
                int w2, int h1, int w1) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* In = reinterpret_cast<bf16*>(smem);
  bf16* Wt = reinterpret_cast<bf16*>(smem + IN_BYTES);
  const int x0 = blockIdx.x * SEG, r = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / WARP, lane = tid % WARP;
  const bf16* mb = mid + (long long)b * hm * w2 * C2;
  const long long plane = (long long)w1 * C2;

  FragC acc[1][C3 / 16];
  zero(acc);
#pragma unroll 1
  for (int kc = 0; kc < C2; kc += KC) {
    __syncthreads();
    for (int i = tid; i < ITEMS; i += THREADS) {
      const Item it = item(i);
      const int rr = r - 1 + it.dh, col = x0 - 1 + it.p;
      __align__(16) bf16 v[8];
      if (rr >= 0 && rr < h1 && col >= 0 && col < w1) {
        const Taps k = lerp_taps(rr, hm, h1);
        const int ja = taps[col], jb = taps[w1 + col];
        const float wa = tapw[col], wb = tapw[w1 + col];
        const float* c0 = cw + (long long)col * C2 + kc + it.c;
        float z0[8], z1[8];
        mid_row8(z0, mb + (long long)k.i0 * w2 * C2 + kc + it.c, ja, jb, wa,
                 wb, C2, c0, c0 + plane, c0 + 2 * plane, k.i0 == 0,
                 k.i0 == hm - 1);
        mid_row8(z1, mb + (long long)k.i1 * w2 * C2 + kc + it.c, ja, jb, wa,
                 wb, C2, c0, c0 + plane, c0 + 2 * plane, k.i1 == 0,
                 k.i1 == hm - 1);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = rbf(lerp(k, z0[e], z1[e]));
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = rbf(0.f);
      }
      *reinterpret_cast<uint4*>(In + (it.dh * (SEG + 2) + it.p) * LDI + it.c) =
          *reinterpret_cast<const uint4*>(v);
    }
    load_taps(Wt, wt2, C3, C2, kc, KC, C3);
    __syncthreads();
    conv_chunk<C3>(acc, In, Wt, warp);
  }

  const float* st = stage<C3>(smem, acc, warp);
  const int px = x0 + warp * 16 + lane;
  if (lane < 16 && px < w1) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < C3; ++c) {
      const float y = fmaxf(__fadd_rn(st[lane * C3 + c], b2[c]), 0.f);
      s = __fadd_rn(s, __fmul_rn(y, w3[c]));
    }
    out[((long long)b * h1 + r) * w1 + px] = fmaxf(__fadd_rn(s, b3[0]), 0.f);
  }
}

template <int C>
int run_front(const void* x, const void* wt1, const void* taps,
              const void* tapw, void* mid, int batch, int h0, int w0,
              void* stream) {
  const int hm = 2 * h0, w2 = 2 * w0;
  return launch(big_front_kernel<C, C / 2>, dim3((w2 + SEG - 1) / SEG, hm, batch),
                THREADS, conv_smem<FRONT_CP<C / 2>>(), stream, (const bf16*)x,
                (const bf16*)wt1, (const int*)taps, (const float*)tapw,
                (bf16*)mid, h0, w0, hm, w2);
}

template <int C2>
int run_back(const void* mid, const void* taps, const void* tapw,
             const void* cw, const void* wt2, const void* b2, const void* w3,
             const void* b3, void* out, int batch, int hm, int w2, int h1,
             int w1, void* stream) {
  return launch(big_back_kernel<C2>, dim3((w1 + SEG - 1) / SEG, h1, batch),
                THREADS, conv_smem<C3>(), stream, (const bf16*)mid,
                (const int*)taps, (const float*)tapw, (const float*)cw,
                (const bf16*)wt2, (const float*)b2, (const float*)w3,
                (const float*)b3, (float*)out, hm, w2, h1, w1);
}

}  // namespace

// Row 11. x (B, H0, W0, C) bf16 contiguous; conv1 with out_conv's mix folded
// in, (9, C, C/2) bf16; W-upsample tap tables (2, 2*W0) int32 / f32 -> mid
// (B, 2*H0, 2*W0, C/2) bf16. C in {64, 128, 256, 384}.
extern "C" int vrvg_head_tail_big_front(const void* x, const void* wt1,
                                        const void* taps, const void* tapw,
                                        void* mid, int batch, int h0, int w0,
                                        int c, void* stream) {
  switch (c) {
    case 64: return run_front<64>(x, wt1, taps, tapw, mid, batch, h0, w0, stream);
    case 128: return run_front<128>(x, wt1, taps, tapw, mid, batch, h0, w0, stream);
    case 256: return run_front<256>(x, wt1, taps, tapw, mid, batch, h0, w0, stream);
    case 384: return run_front<384>(x, wt1, taps, tapw, mid, batch, h0, w0, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Row 12. mid (B, HM, W2, C2) bf16; W-resize tap tables (2, W1); cw (3, W1,
// C2) f32 (cw0, cw1 - cw0, cw2 - cw0); conv2 (9, C2, 32) bf16 + (32,) f32;
// the 1x1 (32,) f32 + (1,) f32 -> out (B, H1, W1) f32. C2 in {32, 64, 128, 192}.
extern "C" int vrvg_head_tail_big_back(const void* mid, const void* taps,
                                       const void* tapw, const void* cw,
                                       const void* wt2, const void* b2,
                                       const void* w3, const void* b3,
                                       void* out, int batch, int hm, int w2,
                                       int c2, int h1, int w1, void* stream) {
  switch (c2) {
    case 32: return run_back<32>(mid, taps, tapw, cw, wt2, b2, w3, b3, out, batch, hm, w2, h1, w1, stream);
    case 64: return run_back<64>(mid, taps, tapw, cw, wt2, b2, w3, b3, out, batch, hm, w2, h1, w1, stream);
    case 128: return run_back<128>(mid, taps, tapw, cw, wt2, b2, w3, b3, out, batch, hm, w2, h1, w1, stream);
    case 192: return run_back<192>(mid, taps, tapw, cw, wt2, b2, w3, b3, out, batch, hm, w2, h1, w1, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
