// The weights' TF32 split for the 3xTF32 GEMM core (csrc/tf32x3_gemm.cuh):
// an nn.Linear weight (N, K) f32 -> its hi and lo planes, once per weight
// (ops/mlp.tf32x3_weight keeps the result with it). Rows 8, 9 and 10 at f32
// take their weights so: w1, w2, w3 plain, w12 gated (rows in
// tf32x3::gated_row's order). Replaces no TPU kernel: the TPU multiplies f32
// operands as they are, and the split is what the tensor cores need for
// f32-accurate products. Bound by bytes (read N K f32, write 2 Npad K),
// once per weight, outside any step.

#include "tf32x3_gemm.cuh"

// w (rows, K) f32 -> out (2, Npad, K) TF32 bit patterns, Npad = rows rounded
// up to 128, or with hidden > 0 (row 10's w12, rows = 2H) 128 ceil(H / 64)
// in the gated order. K a multiple of 4, both pointers 16-byte aligned.
extern "C" int vrvg_tf32x3_split(const void* w, void* out, int rows, int k,
                                 int hidden, void* stream) {
  return tf32x3_gemm::split((const float*)w, (uint32_t*)out, rows, k, hidden,
                            stream);
}

