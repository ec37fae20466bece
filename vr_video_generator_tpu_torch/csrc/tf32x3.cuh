// 3xTF32: an f32 operand as the sum of two TF32 values, so that three
// tensor-core products (hi·hi + hi·lo + lo·hi) give an f32-accurate product
// (csrc/attention_f32.cu, csrc/tf32x3_gemm.cuh). Host and device code
// alike: tests/test_torch_attention_3xtf32.py and
// tests/test_torch_gemm_3xtf32.py build this header with g++.
//
// TF32 keeps f32's sign and 8-bit exponent and the top 10 of its 23
// mantissa bits. rna() rounds an f32 value to it to nearest, ties away from
// zero (PTX cvt.rna.tf32.f32) by integer operations on its bits, and clears
// the low 13 bits, so nothing depends on the tensor core dropping them.
// split() takes hi = rna(x) and lo = rna(x - hi); x - hi is exact in f32,
// and |x - hi - lo| <= 2^-22 |x| for 2^-115 <= |x| with hi finite (below,
// lo stops at TF32's subnormal step, 2^-136), so the terms a 3xTF32
// product leaves out (lo·lo and the operands' residuals) are about 2^-21
// of |a||b|.

#pragma once

#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define TF32X3_FN __host__ __device__ __forceinline__
#else
#define TF32X3_FN inline
#endif

namespace tf32x3 {

TF32X3_FN uint32_t bits(float x) {
#if defined(__CUDA_ARCH__)
  return __float_as_uint(x);
#else
  uint32_t u;
  memcpy(&u, &x, sizeof u);
  return u;
#endif
}

TF32X3_FN float from_bits(uint32_t u) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(u);
#else
  float x;
  memcpy(&x, &u, sizeof x);
  return x;
#endif
}

// The bits of x rounded to TF32. Half a TF32 ulp (bit 12) is added to the
// magnitude: a carry into the exponent is the right rounding, to infinity
// past the largest finite TF32 value. Infinity passes; a NaN stays a NaN
// (its quiet bit set, should its payload lie only in the cleared bits).
TF32X3_FN uint32_t rna_finite(uint32_t u) {
  return (u + 0x1000u) & 0xFFFFE000u;
}

TF32X3_FN uint32_t rna(uint32_t u) {
  if ((u & 0x7F800000u) == 0x7F800000u) {
    return (u & 0xFFFFE000u) | ((u & 0x007FFFFFu) ? 0x00400000u : 0u);
  }
  return rna_finite(u);
}

// x = hi + lo to about 2^-24 |x|, each a TF32 value, as the bits a tensor
// core's .tf32 operand takes.
TF32X3_FN void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(bits(x));
  lo = rna(bits(x - from_bits(hi)));
}

// split() for finite x, without rna()'s infinity and NaN case. A NaN
// (the card's 0x7FFFFFFF) would come out as -0: the caller must see it some
// other way, as csrc/attention_f32.cu's P does in its row sum l.
TF32X3_FN void split_finite(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_finite(bits(x));
  lo = rna_finite(bits(x - from_bits(hi)));
}

// The key that slot s (0-7) of an 8-key group of V^T holds in shared memory
// for P V with P in registers: a wgmma f32 accumulator gives a thread keys
// 2t and 2t + 1 of each 8-key group (t = lane % 4), and wgmma's .tf32
// register A fragment wants k-slots t and t + 4, so key 2t sits at slot t
// and key 2t + 1 at slot t + 4: keys 0, 2, 4, 6, 1, 3, 5, 7.
TF32X3_FN int pv_slot_key(int s) { return s < 4 ? 2 * s : 2 * (s - 4) + 1; }

// The w12 row (2H, K: x1 rows [0, H), x2 rows [H, 2H)) that row p of row
// 10's gated B operand holds (csrc/tf32x3_gemm.cuh): in each 128-row tile
// t, rows u < 64 are x1 of hidden columns 64 t + u and rows u >= 64 x2 of
// the same columns, so the thread of a wgmma m64n128 accumulator that holds
// column c (c % 128 < 64) holds c + 64 too: x1 and x2 of one hidden column.
// -1 where the hidden column is past H (the operand is zero there).
TF32X3_FN int gated_row(int p, int hidden) {
  const int t = p / 128, u = p % 128;
  const int c = 64 * t + u % 64;
  if (c >= hidden) return -1;
  return u < 64 ? c : hidden + c;
}

}  // namespace tf32x3
