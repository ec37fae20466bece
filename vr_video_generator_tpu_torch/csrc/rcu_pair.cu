// refinenet1's residual-unit pair, rcu2(path2 + rcu1(rn0)), for Hopper
// (sm_90a), as a chain of four 3x3 convolutions (C -> C):
//
//   rb  = bf16(relu(b1a + conv1a(relu(rn0))))
//   t   = bf16(b2a + conv2a(rb) + rn0 + path2)
//   rd  = bf16(relu(b1b + conv1b(relu(t))))
//   out = bf16(b2b + conv2b(rd) + t)
//
// Replaces: vr_video_generator_tpu/attic/refinenet_pre.py `_rcu_pair_kernel`
// (refinenet_pre_pallas), at its rounding points (:92-121): each
// accumulator starts at the f32 bias, the ReLU is applied to the loaded
// input and to the output where that kernel has one, the residuals are added
// in f32 in its order (acc + rn0 + path2, then acc + t), every conv
// zero-pads its own input (the image edges), and each conv's output is cast
// to bf16, as the TPU kernel casts each scratch to the input dtype. The
// output is NHWC (B, H0, W0, C): the TPU kernel's channel-major layout with a
// 4-column halo was a Mosaic constraint for its consumer, and the port's
// ext tail reads NHWC.
//
// What bounds it on the H100: at 1080p/vits (B = 8, 148 x 264, C = 64) the
// four convs are 4 x 2 x 9 x 64 x 64 MAC per pixel, ~92 GFLOP (93 us at the
// bf16 peak), against ~2.5 x 40 MB of bf16 inputs and output (30 us at
// 3.35 TB/s): compute-bound. The TPU kernel keeps a row band's
// intermediates in VMEM and recomputes a 12-row halo; here each conv is its
// own launch (attic/refinenet_pre.py chains the four) with its bf16 output
// in device memory (three 40 MB round trips, ~40 us), which is the simple
// form: no halo recompute, one implicit-GEMM conv (csrc/conv3x3.cuh, one
// block of 4 warps per 64-pixel row segment, each warp 16 pixels x all C
// output channels) used four times, and each conv can be held alone against
// its plain version. C in {64, 128}: at C = 128 the nine taps' weights
// (295 KB) are staged in chunks of 32 input channels.

#include "conv3x3.cuh"

namespace {

using namespace vrvg;

constexpr int THREADS = CONV_THREADS;
constexpr int SEG = CONV_SEG;

// One 3x3 conv of (B, H, W, C) bf16: the accumulator starts at the bias,
// with RELU a ReLU on the loaded input and on the f32 output, then NRES bf16
// residuals added in f32 in order, one cast. Grid (segments, H, frames).
template <int C, bool RELU, int NRES>
__global__ void __launch_bounds__(THREADS)
rcu_conv_kernel(const bf16* __restrict__ in, const bf16* __restrict__ wt,
                const float* __restrict__ bias, const bf16* __restrict__ res0,
                const bf16* __restrict__ res1, bf16* __restrict__ out, int h,
                int w) {
  constexpr int KC = conv_kc<C, C>();
  constexpr int LDI = KC + 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* In = reinterpret_cast<bf16*>(smem);
  bf16* Wt = reinterpret_cast<bf16*>(
      smem + align128((size_t)3 * (SEG + 2) * LDI * 2));
  float* St = reinterpret_cast<float*>(
      smem + align128((size_t)3 * (SEG + 2) * LDI * 2) +
      align128((size_t)9 * KC * C * 2));
  const int x0 = blockIdx.x * SEG, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / WARP, lane = tid % WARP;

  // The accumulator starts at the f32 bias: a 16 x C tile of it per warp.
  float* st = St + warp * 16 * C;
  for (int e = lane; e < 16 * C; e += WARP) st[e] = bias[e % C];
  __syncwarp();
  FragC acc[1][C / 16];
#pragma unroll
  for (int j = 0; j < C / 16; ++j)
    wmma::load_matrix_sync(acc[0][j], st + j * 16, C, wmma::mem_row_major);

#pragma unroll 1
  for (int kc = 0; kc < C; kc += KC) {
    __syncthreads();  // the previous chunk fully consumed
    for (int dh = 0; dh < 3; ++dh) {
      const int gr = g - 1 + dh;
      const bool row_ok = gr >= 0 && gr < h;
      const bf16* r = in + ((long long)b * h + (row_ok ? gr : 0)) * w * C + kc;
      for (int i = tid; i < (SEG + 2) * (KC / 8); i += THREADS) {
        const int p = i / (KC / 8), c = (i % (KC / 8)) * 8;
        const int col = x0 - 1 + p;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row_ok && col >= 0 && col < w) {
          v = *reinterpret_cast<const uint4*>(r + (long long)col * C + c);
          if (RELU) {
            bf16* e8 = reinterpret_cast<bf16*>(&v);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (!(bf(e8[e]) > 0.f)) e8[e] = rbf(0.f);
          }
        }
        *reinterpret_cast<uint4*>(In + (dh * (SEG + 2) + p) * LDI + c) = v;
      }
    }
    load_taps(Wt, wt, C, C, kc, KC, C);
    __syncthreads();
    conv3x3_segment<KC, C>(acc, In, Wt, warp);
  }

  __syncwarp();
#pragma unroll
  for (int j = 0; j < C / 16; ++j)
    wmma::store_matrix_sync(st + j * 16, acc[0][j], C, wmma::mem_row_major);
  __syncwarp();
  const long long row = ((long long)b * h + g) * w * C;
  for (int e = lane; e < 16 * C; e += WARP) {
    const int r = e / C, c = e % C;
    const int px = x0 + warp * 16 + r;
    if (px >= w) continue;
    const long long off = row + (long long)px * C + c;
    float v = st[e];
    if (RELU) v = fmaxf(v, 0.f);
    if (NRES >= 1) v = __fadd_rn(v, bf(res0[off]));
    if (NRES >= 2) v = __fadd_rn(v, bf(res1[off]));
    out[off] = rbf(v);
  }
}

template <int C, bool RELU, int NRES>
int conv(const void* in, const void* wt, const void* bias, const void* res0,
         const void* res1, void* out, int batch, int h, int w, void* stream) {
  return launch(rcu_conv_kernel<C, RELU, NRES>,
                dim3((w + SEG - 1) / SEG, h, batch), THREADS,
                conv_smem<conv_kc<C, C>(), C>(), stream, (const bf16*)in,
                (const bf16*)wt, (const float*)bias, (const bf16*)res0,
                (const bf16*)res1, (bf16*)out, h, w);
}

template <int C>
int run(const void* in, const void* wt, const void* bias, const void* res0,
        const void* res1, void* out, int batch, int h, int w, int relu,
        int nres, void* stream) {
  if (relu && nres == 0)
    return conv<C, true, 0>(in, wt, bias, res0, res1, out, batch, h, w, stream);
  if (!relu && nres == 2)
    return conv<C, false, 2>(in, wt, bias, res0, res1, out, batch, h, w, stream);
  if (!relu && nres == 1)
    return conv<C, false, 1>(in, wt, bias, res0, res1, out, batch, h, w, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One conv of the chain: in (B, H0, W0, C) bf16 contiguous, its weights
// (9, C, C) bf16 (tap, in, out) and bias (C,) f32, `nres` residuals (B, H0,
// W0, C) bf16 -> out (B, H0, W0, C) bf16. The chain's three kinds: relu = 1
// with no residual (conv1a, conv1b), relu = 0 with two (conv2a: rn0, path2)
// or one (conv2b: t). C in {64, 128}. Returns cudaGetLastError().
extern "C" int vrvg_rcu_conv(const void* in, const void* wt, const void* bias,
                             const void* res0, const void* res1, void* out,
                             int batch, int h, int w, int c, int relu,
                             int nres, void* stream) {
  switch (c) {
    case 64: return run<64>(in, wt, bias, res0, res1, out, batch, h, w, relu, nres, stream);
    case 128: return run<128>(in, wt, bias, res0, res1, out, batch, h, w, relu, nres, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
