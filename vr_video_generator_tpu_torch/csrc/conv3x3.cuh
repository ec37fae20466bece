// The 3x3 convolution of one 64-pixel output row segment as an implicit GEMM
// on the tensor cores (nvcuda::wmma, bf16 in, f32 accumulate), used by the
// C = 32 and single-kernel DPT tails (csrc/head_tail.cu). A block of
// CONV_THREADS (4 warps) owns one segment:
// the 3 input rows of the segment (+1 halo column each side) and the chunk's
// 9 taps of weights sit in shared memory, and each warp adds its 16 pixels x
// all output channels into its accumulator fragments.

#pragma once

#include "taps.cuh"

namespace vrvg {

constexpr int CONV_THREADS = 128;
constexpr int CONV_SEG = 64;  // output pixels per block

// Over KC input channels at a time: `In` holds 3 input rows x (CONV_SEG + 2)
// pixels x KC channels (pitch KC + 16), `Wt` the chunk's weights as (tap,
// KC, COUT), and each warp adds its 16 pixels x COUT into acc.
template <int KC, int COUT>
__device__ __forceinline__ void conv3x3_segment(
    FragC (&acc)[1][COUT / 16], const bf16* In, const bf16* Wt, int warp) {
  constexpr int LDI = KC + 16;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3, dw = tap % 3;
    const bf16* a = In + (dh * (CONV_SEG + 2) + warp * 16 + dw) * LDI;
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

template <int KC, int COUT>
__host__ __device__ constexpr size_t conv_smem() {
  return align128((size_t)3 * (CONV_SEG + 2) * (KC + 16) * 2) +
         align128((size_t)9 * KC * COUT * 2) +
         (size_t)(CONV_THREADS / WARP) * 16 * COUT * 4;
}

// Input channels per chunk: all of them; the nine taps' weights of every
// conv here (the tails' conv1 at C <= 128, every conv2) fit in shared
// memory beside the input rows.
template <int CIN, int COUT>
__host__ __device__ constexpr int conv_kc() {
  static_assert(conv_smem<CIN, COUT>() <= 232448, "shared memory");
  return CIN;
}

}  // namespace vrvg
