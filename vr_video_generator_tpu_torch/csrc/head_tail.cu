// The DPT head's tail from refinenet1's pre-upsample activation to depth at
// C = 32 (a custom head's width: row 7 at every encoder's width, C = 64 to
// 384, is csrc/head_tail_big.cu's vrvg_head_tail_ext_front and the row-12
// back), for Hopper (sm_90a), as a chain of three kernels:
//
//   1. mix_wresize: out_conv's 1x1 channel mix per input pixel (tensor-core
//      GEMM) -> bf16, then the x2 align-corners W-resize -> bf16   (H0, W2)
//   2. conv1:       the x2 H-resize + out_conv bias, zero outside the image
//      -> bf16, then output_conv1 3x3 (C -> C/2) as an implicit GEMM,
//      + f32 bias -> bf16                                           (HM, W2)
//   3. conv2:       the W-resize to the net width -> bf16, the H-resize
//      -> bf16, zero outside, output_conv2 3x3 (C/2 -> 32) as an implicit
//      GEMM + f32 bias, ReLU, the 1x1 (32 -> 1) summed in f32 + bias, ReLU
//      -> f32 depth                                                 (H1, W1)
//
// The same file holds the single-kernel tail at C = 32 (head_tail_wmma,
// which csrc/head_tail_big.cu's vrvg_head_tail runs at that width; C = 64
// and 128 run there on the Hopper chain), replacing head_tail_pallas.py
// `_tail_kernel` (head_tail_pallas, row 15): path1 (B, H2, W2, 32) -> conv1
// read straight from path1 with zero padding, its f32 sum, then + b1, then
// the cast (:113-121), and then stage 3 below, which is that kernel's back
// half (:123-153) at the same rounding points.
//
// Replaces: vr_video_generator_tpu/ops/head_tail_pallas.py
// `_tail_ext_kernel` (head_tail_ext_pallas) at C = 32, the same order and
// rounding points (:287-354): the out_conv mix before the W-resize, the
// resize weights in bf16 (ops/resize.linear_weights), the H-resizes as exact
// integer taps r * (n_in - 1) // (n_out - 1) with an f32 fraction and an f32
// lerp, conv1's f32 bias added BEFORE its cast to bf16 (unlike the dense
// layers), conv2's f32 bias and ReLU, the f32 1x1 and its bias. Every
// product and sum outside the tensor cores is an explicit __fmul_rn /
// __fadd_rn. A W-resize has two non-zero taps per output, so the kernels
// compute fl(wa * x0 + wb * x1) from per-column tap tables; that is what the
// TPU's dense resize GEMM gives (bf16 x bf16 products are exact in f32).
//
// Design (simple first: no pipelining, weights re-read from L2 by every
// block): the two row-local stages (mix + W-resize, conv1) write bf16
// intermediates to device memory, and the resizes feeding each convolution
// are computed while its input tile is loaded into shared memory. The
// convolutions are implicit GEMMs on the tensor cores (nvcuda::wmma, bf16
// in, f32 accumulate): one block of 4 warps per 64-pixel segment of one
// output row, the 3 input rows of the segment (+1 halo column each side) and
// all 9 taps' weights in shared memory, each warp owning 16 pixels x all
// output channels (csrc/conv3x3.cuh). The first kernel holds a whole input
// row in shared memory. (At C = 64 to 384 this chain took 3.2 to 10.3 ms at
// 1080p, B = 8, on an H100, 27-41x its bound: every block restaged all nine
// taps' weights for one 64-pixel segment.)

#include "conv3x3.cuh"

namespace {

using namespace vrvg;

constexpr int THREADS = CONV_THREADS;
constexpr int SEG = CONV_SEG;     // output pixels per conv block
constexpr int C3 = 32;            // output_conv2's width (reference head)
// Output channels of the out_conv mix per pass of the first kernel.
template <int C>
constexpr int MIX_NC = C < 64 ? C : 64;

// ---------------------------------------------------------------------------
// 1. out_conv mix + W-resize. One block per (row, frame).

template <int C>
__global__ void __launch_bounds__(THREADS)
mix_wresize_kernel(const bf16* __restrict__ x, long long sb, long long sh,
                   long long sw, long long sc, int w0,
                   const bf16* __restrict__ koc,   // (C out, C in)
                   const int* __restrict__ taps,   // (2, W2) j0, j1
                   const float* __restrict__ tapw, // (2, W2) wa, wb
                   bf16* __restrict__ rw, int h0n, int w2) {
  constexpr int LD = C + 16;
  constexpr int NC = MIX_NC<C>;
  const int w0p = (w0 + 15) / 16 * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t xs_bytes = align128((size_t)w0p * LD * 2);
  constexpr size_t ks_bytes = align128((size_t)NC * LD * 2);
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + xs_bytes);
  bf16* Xo = reinterpret_cast<bf16*>(smem + xs_bytes + ks_bytes);
  float* St = reinterpret_cast<float*>(
      smem + xs_bytes + ks_bytes + align128((size_t)w0p * NC * 2));
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / WARP, lane = tid % WARP;

  const bf16* src = x + b * sb + h * sh;
  for (int i = tid; i < C * w0p; i += THREADS) {
    const int c = i / w0p, w = i % w0p;
    Xs[w * LD + c] = w < w0 ? src[w * sw + c * sc] : rbf(0.f);
  }
  bf16* dst = rw + ((long long)b * h0n + h) * w2 * C;
  float* st = St + warp * 256;
  constexpr int TN = NC / 16;
  const int tiles = (w0p / 16) * TN;
#pragma unroll 1
  for (int n0 = 0; n0 < C; n0 += NC) {
    __syncthreads();  // Xs staged; the previous pass's Xo fully read
    load_rows(Ks, LD, koc + (long long)n0 * C, C, NC, C, NC, tid, THREADS);
    __syncthreads();

    // Xo = bf16(Xs @ koc[n0 : n0 + NC]^T): (w0p x C) x (C x NC), one 16 x 16
    // tile per step, each over the whole of C.
    for (int t = warp; t < tiles; t += THREADS / WARP) {
      const int tm = t / TN, tn = t % TN;
      FragC acc[1][1];
      zero(acc);
      mma_block<1, 1, C>(acc, Xs + tm * 16 * LD, LD, Ks + tn * 16 * LD, LD);
      wmma::store_matrix_sync(st, acc[0][0], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += WARP)
        Xo[(tm * 16 + e / 16) * NC + tn * 16 + e % 16] = rbf(st[e]);
      __syncwarp();
    }
    __syncthreads();

    for (int i = tid; i < w2 * (NC / 8); i += THREADS) {
      const int w = i / (NC / 8), c = (i % (NC / 8)) * 8;
      __align__(16) bf16 v[8];
      wlerp8(v, Xo + taps[w] * NC + c, Xo + taps[w2 + w] * NC + c, tapw[w],
             tapw[w2 + w]);
      *reinterpret_cast<uint4*>(dst + (long long)w * C + n0 + c) =
          *reinterpret_cast<const uint4*>(v);
    }
  }
}

template <int C>
size_t mix_smem(int w0) {
  const size_t w0p = (w0 + 15) / 16 * 16;
  constexpr size_t NC = MIX_NC<C>;
  return align128(w0p * (C + 16) * 2) + align128(NC * (C + 16) * 2) +
         align128(w0p * NC * 2) + (THREADS / WARP) * 256 * 4;
}

// ---------------------------------------------------------------------------
// 2. H-resize (+ out_conv bias) + conv1 (+ f32 bias) -> bf16 c1.
// Grid (segments, HM rows, frames). Without RESIZE (the single-kernel tail,
// vrvg_head_tail) `rw` is path1 itself, (B, HM, W2, C), read as it is with
// zero padding, and `boc` and `h0n` are not read.

template <int C, int C2, bool RESIZE>
__global__ void __launch_bounds__(THREADS)
conv1_kernel(const bf16* __restrict__ rw, const float* __restrict__ boc,
             const bf16* __restrict__ wt1, const float* __restrict__ b1,
             bf16* __restrict__ c1, int h0n, int hm, int w2) {
  constexpr int KC = conv_kc<C, C2>();
  constexpr int LDI = KC + 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* In = reinterpret_cast<bf16*>(smem);
  bf16* Wt = reinterpret_cast<bf16*>(
      smem + align128((size_t)3 * (SEG + 2) * LDI * 2));
  float* St = reinterpret_cast<float*>(
      smem + align128((size_t)3 * (SEG + 2) * LDI * 2) +
      align128((size_t)9 * KC * C2 * 2));
  const int x0 = blockIdx.x * SEG, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / WARP, lane = tid % WARP;

  FragC acc[1][C2 / 16];
  zero(acc);
#pragma unroll 1
  for (int kc = 0; kc < C; kc += KC) {
    __syncthreads();  // the previous chunk fully consumed
    for (int dh = 0; dh < 3; ++dh) {
      const int gr = g - 1 + dh;
      const bool row_ok = gr >= 0 && gr < hm;
      if constexpr (!RESIZE) {
        const bf16* r = rw + ((long long)b * hm + (row_ok ? gr : 0)) * w2 * C + kc;
        for (int i = tid; i < (SEG + 2) * (KC / 8); i += THREADS) {
          const int p = i / (KC / 8), c = (i % (KC / 8)) * 8;
          const int col = x0 - 1 + p;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (row_ok && col >= 0 && col < w2)
            v = *reinterpret_cast<const uint4*>(r + (long long)col * C + c);
          *reinterpret_cast<uint4*>(In + (dh * (SEG + 2) + p) * LDI + c) = v;
        }
        continue;
      }
      const Taps k = lerp_taps(row_ok ? gr : 0, h0n, hm);
      const bf16* r0 = rw + ((long long)b * h0n + k.i0) * w2 * C + kc;
      const bf16* r1 = rw + ((long long)b * h0n + k.i1) * w2 * C + kc;
      for (int i = tid; i < (SEG + 2) * (KC / 8); i += THREADS) {
        const int p = i / (KC / 8), c = (i % (KC / 8)) * 8;
        const int col = x0 - 1 + p;
        __align__(16) bf16 v[8];
        if (row_ok && col >= 0 && col < w2) {
          const uint4 ua = *reinterpret_cast<const uint4*>(r0 + (long long)col * C + c);
          const uint4 ub = *reinterpret_cast<const uint4*>(r1 + (long long)col * C + c);
          const bf16* a = reinterpret_cast<const bf16*>(&ua);
          const bf16* bb = reinterpret_cast<const bf16*>(&ub);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = rbf(__fadd_rn(lerp(k, bf(a[e]), bf(bb[e])), boc[kc + c + e]));
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = rbf(0.f);
        }
        *reinterpret_cast<uint4*>(In + (dh * (SEG + 2) + p) * LDI + c) =
            *reinterpret_cast<const uint4*>(v);
      }
    }
    load_taps(Wt, wt1, C2, C, kc, KC, C2);
    __syncthreads();
    conv3x3_segment<KC, C2>(acc, In, Wt, warp);
  }

  float* st = St + warp * 16 * C2;
#pragma unroll
  for (int j = 0; j < C2 / 16; ++j)
    wmma::store_matrix_sync(st + j * 16, acc[0][j], C2, wmma::mem_row_major);
  __syncwarp();
  bf16* dst = c1 + ((long long)b * hm + g) * w2 * C2;
  for (int e = lane; e < 16 * C2; e += WARP) {
    const int r = e / C2, c = e % C2;
    const int px = x0 + warp * 16 + r;
    if (px < w2) dst[(long long)px * C2 + c] = rbf(__fadd_rn(st[e], b1[c]));
  }
}

// ---------------------------------------------------------------------------
// 3. W-resize + H-resize + conv2 + ReLU + 1x1 + ReLU -> f32 depth.
// Grid (segments, H1 rows, frames).

template <int C2>
__global__ void __launch_bounds__(THREADS)
conv2_kernel(const bf16* __restrict__ c1, const int* __restrict__ taps,
             const float* __restrict__ tapw, const bf16* __restrict__ wt2,
             const float* __restrict__ b2, const float* __restrict__ w3,
             const float* __restrict__ b3, float* __restrict__ out, int hm,
             int w2, int h1, int w1) {
  constexpr int KC = conv_kc<C2, C3>();
  constexpr int LDI = KC + 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* In = reinterpret_cast<bf16*>(smem);
  bf16* Wt = reinterpret_cast<bf16*>(
      smem + align128((size_t)3 * (SEG + 2) * LDI * 2));
  float* St = reinterpret_cast<float*>(
      smem + align128((size_t)3 * (SEG + 2) * LDI * 2) +
      align128((size_t)9 * KC * C3 * 2));
  const int x0 = blockIdx.x * SEG, r = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / WARP, lane = tid % WARP;

  FragC acc[1][C3 / 16];
  zero(acc);
#pragma unroll 1
  for (int kc = 0; kc < C2; kc += KC) {
    __syncthreads();  // the previous chunk fully consumed
    for (int dh = 0; dh < 3; ++dh) {
      const int rr = r - 1 + dh;
      const bool row_ok = rr >= 0 && rr < h1;
      const Taps k = lerp_taps(row_ok ? rr : 0, hm, h1);
      const bf16* r0 = c1 + ((long long)b * hm + k.i0) * w2 * C2 + kc;
      const bf16* r1 = c1 + ((long long)b * hm + k.i1) * w2 * C2 + kc;
      for (int i = tid; i < (SEG + 2) * (KC / 8); i += THREADS) {
        const int p = i / (KC / 8), c = (i % (KC / 8)) * 8;
        const int col = x0 - 1 + p;
        __align__(16) bf16 v[8];
        if (row_ok && col >= 0 && col < w1) {
          const int ja = taps[col], jb = taps[w1 + col];
          const float wa = tapw[col], wb = tapw[w1 + col];
          __align__(16) bf16 z0[8], z1[8];
          const uint4 a0 = *reinterpret_cast<const uint4*>(r0 + (long long)ja * C2 + c);
          const uint4 b0 = *reinterpret_cast<const uint4*>(r0 + (long long)jb * C2 + c);
          const uint4 a1 = *reinterpret_cast<const uint4*>(r1 + (long long)ja * C2 + c);
          const uint4 b1v = *reinterpret_cast<const uint4*>(r1 + (long long)jb * C2 + c);
          wlerp8(z0, reinterpret_cast<const bf16*>(&a0),
                 reinterpret_cast<const bf16*>(&b0), wa, wb);
          wlerp8(z1, reinterpret_cast<const bf16*>(&a1),
                 reinterpret_cast<const bf16*>(&b1v), wa, wb);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = rbf(lerp(k, bf(z0[e]), bf(z1[e])));
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = rbf(0.f);
        }
        *reinterpret_cast<uint4*>(In + (dh * (SEG + 2) + p) * LDI + c) =
            *reinterpret_cast<const uint4*>(v);
      }
    }
    load_taps(Wt, wt2, C3, C2, kc, KC, C3);
    __syncthreads();
    conv3x3_segment<KC, C3>(acc, In, Wt, warp);
  }

  float* st = St + warp * 16 * C3;
#pragma unroll
  for (int j = 0; j < C3 / 16; ++j)
    wmma::store_matrix_sync(st + j * 16, acc[0][j], C3, wmma::mem_row_major);
  __syncwarp();
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
int run(const void* x, long long sb, long long sh, long long sw, long long sc,
        int batch, int h0, int w0, const void* koc, const void* boc,
        const void* wt1, const void* b1, const void* wt2, const void* b2,
        const void* w3, const void* b3, const void* taps_a,
        const void* tapw_a, const void* taps_b, const void* tapw_b, void* rw,
        void* c1, void* out, int h1, int w1, void* stream) {
  constexpr int C2 = C / 2;
  const int hm = 2 * h0, w2 = 2 * w0;
  int err = launch(mix_wresize_kernel<C>, dim3(h0, batch), THREADS,
                   mix_smem<C>(w0), stream, (const bf16*)x, sb, sh, sw, sc,
                   w0, (const bf16*)koc, (const int*)taps_a,
                   (const float*)tapw_a, (bf16*)rw, h0, w2);
  if (err) return err;
  err = launch(conv1_kernel<C, C2, true>, dim3((w2 + SEG - 1) / SEG, hm, batch),
               THREADS, conv_smem<conv_kc<C, C2>(), C2>(), stream, (const bf16*)rw,
               (const float*)boc, (const bf16*)wt1, (const float*)b1,
               (bf16*)c1, h0, hm, w2);
  if (err) return err;
  return launch(conv2_kernel<C2>, dim3((w1 + SEG - 1) / SEG, h1, batch),
                THREADS, conv_smem<conv_kc<C2, C3>(), C3>(), stream, (const bf16*)c1,
                (const int*)taps_b, (const float*)tapw_b, (const bf16*)wt2,
                (const float*)b2, (const float*)w3, (const float*)b3,
                (float*)out, hm, w2, h1, w1);
}

}  // namespace

namespace vrvg {

// The single-kernel tail at C = 32: conv1 straight from path1 (B, H2, W2,
// 32) bf16 contiguous with wt1 (3, 3, 32, 16), then conv2 as above with wt2
// (3, 3, 16, 32); scratch c1 (B, H2, W2, 16). Returns a CUDA error code.
int head_tail_wmma(const void* x, int batch, int h2, int w2, const void* wt1,
                   const void* b1, const void* wt2, const void* b2,
                   const void* w3, const void* b3, const void* taps,
                   const void* tapw, void* c1, void* out, int h1, int w1,
                   void* stream) {
  constexpr int C = 32, C2 = C / 2;
  int err = launch(conv1_kernel<C, C2, false>,
                   dim3((w2 + SEG - 1) / SEG, h2, batch), THREADS,
                   conv_smem<conv_kc<C, C2>(), C2>(), stream, (const bf16*)x,
                   (const float*)nullptr, (const bf16*)wt1, (const float*)b1,
                   (bf16*)c1, h2, h2, w2);
  if (err) return err;
  return launch(conv2_kernel<C2>, dim3((w1 + SEG - 1) / SEG, h1, batch),
                THREADS, conv_smem<conv_kc<C2, C3>(), C3>(), stream,
                (const bf16*)c1, (const int*)taps, (const float*)tapw,
                (const bf16*)wt2, (const float*)b2, (const float*)w3,
                (const float*)b3, (float*)out, h2, w2, h1, w1);
}

}  // namespace vrvg

// x (B, H0, W0, C) bf16 with element strides (sb, sh, sw, sc); out_conv
// (C out, C in) bf16 + (C,) f32 bias; conv1 (9, C, C/2) bf16 + (C/2,) f32;
// conv2 (9, C/2, 32) bf16 + (32,) f32; the 1x1 (32,) f32 + (1,) f32;
// W-resize tap tables (2, 2*W0) / (2, W1) int32 indices and f32 weights;
// scratch rw (B, H0, 2*W0, C) and c1 (B, 2*H0, 2*W0, C/2) bf16 ->
// out (B, H1, W1) f32. C = 32. The first kernel holds a whole input row in
// shared memory: an input too wide for it fails to launch.
extern "C" int vrvg_head_tail_ext(
    const void* x, long long sb, long long sh, long long sw, long long sc,
    int batch, int h0, int w0, int c, const void* koc, const void* boc,
    const void* wt1, const void* b1, const void* wt2, const void* b2,
    const void* w3, const void* b3, const void* taps_a, const void* tapw_a,
    const void* taps_b, const void* tapw_b, void* rw, void* c1, void* out,
    int h1, int w1, void* stream) {
  if (c != 32) return (int)cudaErrorInvalidValue;
  return run<32>(x, sb, sh, sw, sc, batch, h0, w0, koc, boc, wt1, b1, wt2,
                 b2, w3, b3, taps_a, tapw_a, taps_b, tapw_b, rw, c1, out, h1,
                 w1, stream);
}
