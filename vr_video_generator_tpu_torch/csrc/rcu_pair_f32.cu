// refinenet1's residual-unit pair at f32 (--compute_dtype float32),
// rcu2(path2 + rcu1(rn0)), for Hopper (sm_90a), as the chain of four 3x3
// convolutions (C -> C) of csrc/rcu_pair.cu, each at f32:
//
//   rb  = relu(b1a + conv1a(relu(rn0)))
//   t   = b2a + conv2a(rb) + rn0 + path2
//   rd  = relu(b1b + conv1b(relu(t)))
//   out = b2b + conv2b(rd) + t
//
// Replaces: vr_video_generator_tpu/attic/refinenet_pre.py `_rcu_pair_kernel`
// (row 16, refinenet_pre_pallas) run at f32, at its rounding points
// (:92-121): the f32 bias and the f32 products make each accumulator, the
// ReLU applied to the loaded input and to the output where that kernel has
// one, the residuals added in f32 in its order (acc + rn0 + path2, then acc
// + t), every conv zero-padding its own input. Every intermediate is f32,
// so nothing is cast; the sums' order is the only difference (the TPU
// kernel starts its sum at the bias, this one adds the bias to the sum).
//
// Design: each conv is an implicit GEMM on the 3xTF32 wgmma core
// (csrc/tf32x3_gemm.cuh conv_kernel: tiles of 4 image rows x 32 pixels, one
// TMA halo box of the NHWC image a 32-channel slice, split once into TF32
// hi/lo planes in shared memory and read at each tap's shifted rows; K = 9
// C; 64-wide column tiles, C / 64 of them rounded up: one at C = 64, two
// at C = 96 (the second half idle) and 128, six at vitg's 384), its weights
// given as their TF32 split (ops/head_tail._conv_split, made once a weight
// by the wrapper), its epilogue RcuEpi adding the bias, the ReLU and the
// residuals to each pair of f32 sums (vrvg::rcu_out_f32,
// csrc/epilogue_f32.cuh) and writing the ReLU'd copy. TMA's zero fill past
// the image is each conv's own zero padding, and the rows of the ragged
// last tile of a 264-pixel row map to no pixel. As at bf16 the input ReLUs
// are made beforehand, since TMA cannot apply them on the way in, so that
// the wrapper's calls and their plain versions are the same at both
// dtypes: relu(rn0) by a pass over rn0 before conv1a (relu_kernel), relu(t)
// by conv2a's epilogue, which writes it beside t. The ReLU of an f32 value
// is exact, so reading the relu'd copy is the TPU kernel's ReLU on the load.
//
// What bounds it on the H100: at 1080p/vits (B = 8, 148 x 264, C = 64) the
// four convs are ~92 GFLOP, 0.56 ms at 3xTF32's f32-accurate 165 TFLOP/s (a
// third of the card's dense TF32 rate), against ~5 x 80 MB of f32 inputs,
// outputs and intermediates (0.12 ms at 3.35 TB/s); at vitb's C = 128 369
// GFLOP (2.2 ms): bound by operations, since wgmma takes no f32 operands
// and TF32 alone is not f32 (csrc/tf32x3_gemm.cuh's header).

#include "tf32x3_gemm.cuh"

namespace {

// out = relu(in) over n f32 values (n a multiple of 4, 16-byte aligned),
// 16 bytes a thread, grid-stride; -0 and NaN become +0, as the bf16 pass.
constexpr int RELU_THREADS = 256;

__global__ void __launch_bounds__(RELU_THREADS)
relu_kernel(const float4* __restrict__ in, float4* __restrict__ out,
            long long n4) {
  for (long long i = blockIdx.x * (long long)RELU_THREADS + threadIdx.x;
       i < n4; i += (long long)gridDim.x * RELU_THREADS) {
    const float4 v = in[i];
    out[i] = make_float4(v.x > 0.f ? v.x : 0.f, v.y > 0.f ? v.y : 0.f,
                         v.z > 0.f ? v.z : 0.f, v.w > 0.f ? v.w : 0.f);
  }
}

template <bool RELU, int NRES>
int conv(const void* in, const void* ws, const void* bias, const void* res0,
         const void* res1, void* out, void* relu_copy, int batch, int h,
         int w, int c, void* stream) {
  return tf32x3_gemm::conv3x3<64>(
      (const float*)in, (const uint32_t*)ws, batch, h, w, c, c,
      tf32x3_gemm::RcuEpi<RELU, NRES>{c, (float*)out, (const float*)bias,
                                      (const float*)res0, (const float*)res1,
                                      (float*)relu_copy},
      stream);
}

}  // namespace

// One conv of the chain at f32, with vrvg_rcu_conv's arguments (csrc/
// rcu_pair.cu) in f32: in (B, H0, W0, C) f32 contiguous; with relu and a
// non-null `in_relu` (B, H0, W0, C) scratch, relu(in) is written there
// first and the conv reads it, with relu and a null one `in` is relu'd
// already; its weights (C, 9 C) f32 (k = (3 dh + dw) C + c) given as their
// TF32 split `ws` (vrvg_tf32x3_split: (2, 128 ceil(C / 128), 9 C) 32-bit
// words) and its bias (C,) f32; `nres` residuals (B, H0, W0, C) f32 -> out
// (B, H0, W0, C) f32, and relu(out) into `out_relu` unless it is null. The
// chain's three kinds: relu = 1 with no residual and no out_relu (conv1a,
// conv1b), relu = 0 with two (conv2a: rn0, path2) or one (conv2b: t). C a
// positive multiple of 32 (the wrapper zero-pads another width,
// attic/refinenet_pre.rcu_width); every pointer 16-byte aligned. Returns a
// CUDA error code (a tensor map that does not encode:
// cudaErrorInvalidValue).
extern "C" int vrvg_rcu_conv_f32(const void* in, void* in_relu,
                                 const void* ws, const void* bias,
                                 const void* res0, const void* res1,
                                 void* out, void* out_relu, int batch, int h,
                                 int w, int c, int relu, int nres,
                                 void* stream) {
  if (c <= 0 || c % 32 != 0) return (int)cudaErrorInvalidValue;
  if (in_relu != nullptr && !relu) return (int)cudaErrorInvalidValue;
  const bool ok = relu ? nres == 0 && out_relu == nullptr
                       : nres == 1 || nres == 2;
  if (!ok) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || h <= 0 || w <= 0) return (int)cudaSuccess;
  if (in_relu != nullptr) {
    const long long n4 = (long long)batch * h * w * c / 4;
    const long long blocks = (n4 + RELU_THREADS - 1) / RELU_THREADS;
    relu_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), RELU_THREADS, 0,
                  (cudaStream_t)stream>>>((const float4*)in,
                                          (float4*)in_relu, n4);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    in = in_relu;
  }
  if (relu) {
    return conv<true, 0>(in, ws, bias, res0, res1, out, nullptr, batch, h, w,
                         c, stream);
  }
  if (nres == 2) {
    return conv<false, 2>(in, ws, bias, res0, res1, out, out_relu, batch, h,
                          w, c, stream);
  }
  return conv<false, 1>(in, ws, bias, res0, res1, out, out_relu, batch, h, w,
                        c, stream);
}
