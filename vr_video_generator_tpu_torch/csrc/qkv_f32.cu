// The two ends of the fused attention half-block at f32, for Hopper
// (sm_90a): the f32 variants of csrc/qkv.cu's kernels, for
// --compute_dtype float32.
//
//   ln_qkv_f32:            x -> LN1 -> qkv GEMM -> + bias -> q * scale
//   proj_ls_residual_f32:  o -> proj GEMM -> + bias -> gamma * . -> x + .
//
// Replaces: vr_video_generator_tpu/ops/qkv_pallas.py `_ln_qkv_kernel`
// (ln_qkv_pallas, row 5) and `_proj_kernel` (proj_ls_residual_pallas, row
// 6) run at f32, where the JAX package plans them (qkv_pallas.attn_fusable:
// vits and vitb, not vitl's D = 1024 at f32). Rounding points as there at
// f32: LN with f32 statistics and affine; the GEMM's f32 sums, + bias; q =
// f32(q) * scale; gamma * y, then x + that. Each sum and product of the
// epilogues is an explicit __fadd_rn / __fmul_rn.
//
// Layout as csrc/qkv.cu's: ln_qkv writes the (M, 3D) product, i.e. (B, N,
// 3, H, 64), whose q, k and v slices the attention kernel reads as strided
// views; proj reads the attention output (B, N, H, 64) as (M, D).
//
// What bounds them on the H100: at 1080p/vits (M = 8 * 2443, D = 384)
// ln_qkv is 17.3 GFLOP, 0.258 ms at the card's 67 TFLOP/s f32 rate outside
// the tensor cores, against ~105 MB of f32 traffic (0.031 ms); proj is 5.8
// GFLOP (0.086 ms) against ~91 MB (0.027 ms): both bound by operations,
// since f32 products cannot use the tensor cores (csrc/sgemm.cuh's header).
//
// Design: ln_qkv is a chain of row 1's f32 LayerNorm (csrc/layernorm.cu,
// vrvg_layernorm_f32) into an (M, D) f32 scratch, then the f32 GEMM core
// (csrc/sgemm.cuh, 128 x 128 tiles) with the bias and q's scale in its
// epilogue (QkvF32); proj is one launch of the core with bias, LayerScale
// and the residual in its epilogue (ProjF32). vrvg_qkv_f32, the GEMM stage
// alone, exposes the product for the CPU emulation of the core
// (tests/test_torch_f32_emulation.py).

#include "sgemm.cuh"

extern "C" int vrvg_layernorm_f32(const void* x, const void* w,
                                  const void* b, void* y, int m, int d,
                                  float eps, void* stream);

namespace {

using sgemm::for_each4;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// [q * scale | k | v] = a w^T + bias, q's columns (< d) scaled.
struct QkvF32 {
  float* out;         // (M, 3D)
  const float* bias;  // (3D,)
  int d;
  float scale;
  template <class T>
  __device__ __forceinline__ void store(int row, int n0, int tx,
                                        const float (&v)[T::TN]) const {
    float* dst = out + (long long)row * 3 * d;
    for_each4<T>(n0, tx, 3 * d, v, [&](int col, const float* s) {
      const float4 b = ld4(bias + col);
      float4 t = make_float4(__fadd_rn(s[0], b.x), __fadd_rn(s[1], b.y),
                             __fadd_rn(s[2], b.z), __fadd_rn(s[3], b.w));
      if (col < d) {  // d is a multiple of 4: a group is all q or none
        t.x = __fmul_rn(t.x, scale), t.y = __fmul_rn(t.y, scale);
        t.z = __fmul_rn(t.z, scale), t.w = __fmul_rn(t.w, scale);
      }
      *reinterpret_cast<float4*>(dst + col) = t;
    });
  }
};

// out = x + gamma * (o w^T + bias).
struct ProjF32 {
  float* out;          // (M, D)
  const float* x;      // (M, D)
  const float* bias;   // (D,)
  const float* gamma;  // (D,)
  int d;
  template <class T>
  __device__ __forceinline__ void store(int row, int n0, int tx,
                                        const float (&v)[T::TN]) const {
    const long long base = (long long)row * d;
    for_each4<T>(n0, tx, d, v, [&](int col, const float* s) {
      const float4 b = ld4(bias + col), g = ld4(gamma + col);
      const float4 r = ld4(x + base + col);
      *reinterpret_cast<float4*>(out + base + col) = make_float4(
          __fadd_rn(r.x, __fmul_rn(g.x, __fadd_rn(s[0], b.x))),
          __fadd_rn(r.y, __fmul_rn(g.y, __fadd_rn(s[1], b.y))),
          __fadd_rn(r.z, __fmul_rn(g.z, __fadd_rn(s[2], b.z))),
          __fadd_rn(r.w, __fmul_rn(g.w, __fadd_rn(s[3], b.w))));
    });
  }
};

}  // namespace

// Row 5's GEMM stage: a (M, D) f32 LayerNorm'd rows, w (3D, D) f32, b (3D,)
// f32 -> out (M, 3D) f32 = (B, N, 3, H, 64). D a multiple of 4.
extern "C" int vrvg_qkv_f32(const void* a, const void* w, const void* b,
                            void* out, int m, int d, float scale,
                            void* stream) {
  const sgemm::DenseRows A{(const float*)a, d, m, d};
  const sgemm::DenseRows W{(const float*)w, d, 3 * d, d};
  return sgemm::gemm<sgemm::Square>(A, W, m, 3 * d, d,
                                    QkvF32{(float*)out, (const float*)b, d,
                                           scale},
                                    stream);
}

// Row 5 at f32: x (M, D) f32, LN affine (D,) f32, w (3D, D), b (3D,) f32;
// scratch a (M, D) f32 -> out (M, 3D) f32.
extern "C" int vrvg_ln_qkv_f32(const void* x, const void* lnw,
                               const void* lnb, const void* w, const void* b,
                               void* a, void* out, int m, int d, float scale,
                               float eps, void* stream) {
  const int err = vrvg_layernorm_f32(x, lnw, lnb, a, m, d, eps, stream);
  if (err != 0) return err;
  return vrvg_qkv_f32(a, w, b, out, m, d, scale, stream);
}

// Row 6 at f32: o (M, D) f32 (the attention output), x (M, D) f32 residual,
// w (D, D), b (D,), gamma (D,) f32 -> out (M, D) f32 = x + gamma * (o w^T +
// b). D a multiple of 4.
extern "C" int vrvg_proj_ls_residual_f32(const void* o, const void* x,
                                         const void* w, const void* b,
                                         const void* gamma, void* out, int m,
                                         int d, void* stream) {
  const sgemm::DenseRows A{(const float*)o, d, m, d};
  const sgemm::DenseRows W{(const float*)w, d, d, d};
  return sgemm::gemm<sgemm::Square>(
      A, W, m, d, d,
      ProjF32{(float*)out, (const float*)x, (const float*)b,
              (const float*)gamma, d},
      stream);
}
