// The launch plan of kernel 1 (rows 2 and 17 at any head dim but 64,
// csrc/attention_any.cu at bf16, csrc/attention_any_f32.cu at f32) by head
// dim: how the head dim is cut into 128-byte chunks, how many 64-row q
// groups and column groups a block runs, the key tile, whether Q stays in
// shared memory, and the ring's depth. Host and device code alike:
// tests/test_torch_attention_any_plan.py builds this header with g++ and
// holds every head dim from 1 to 1024 to the card's shared-memory and
// register budgets and to ops/attention.py's mirror of it.
//
// A chunk is one 128-byte row of the 128-byte swizzle: 64 bf16 or 32 f32
// head dims (an f32 chunk is stored twice, its TF32 hi and lo planes). The
// head dim is zero-padded to DP = c chunks. A block holds qg q groups of 64
// rows and, for each, g consumer warpgroups, each owning oc chunks of O's
// columns; the cb column blocks of a q tile each take g * oc chunks of
// columns and compute S over the whole head dim (g * cb copies of S: the
// FLOP multiple below). With Q resident, Q's c chunks are loaded once and
// the ring carries a K tile and a V tile a key tile; otherwise each key
// tile's S walks ns = ceil(c / sc) slabs, each a stage holding sc chunks
// of Q and of K.

#pragma once

#if defined(__CUDACC__)
#define PLAN_FN __host__ __device__ constexpr
#else
#define PLAN_FN constexpr
#endif

namespace attn_any {

constexpr int ROW_BYTES = 128;           // one swizzle row, one chunk
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory a block
constexpr int REG_LIMIT = 65536;         // registers an SM
constexpr int MAX_STAGES = 8;
constexpr int BF16_SLAB = 4;             // chunks a streamed S slab (256 dims)
constexpr int F32_SLAB = 2;              // (64 dims: one fresh 3xTF32 sum)

struct Plan {
  int f32;     // 1: f32 on 3xTF32, 0: bf16
  int c;       // chunks of the padded head dim DP
  int qg;      // 64-row q groups a block
  int g;       // consumer warpgroups a q group (column groups)
  int oc;      // O chunks a consumer
  int cb;      // column blocks (a grid axis)
  int bn;      // keys a tile
  int sc;      // chunks a stage of S: c when Q is resident
  int stages;  // ring depth
  int pw;      // 1: a producer warp issues the TMA loads; 0: a consumer's
               // thread 0 does, under its products

  PLAN_FN int chunk() const { return f32 ? 32 : 64; }
  PLAN_FN int dp() const { return c * chunk(); }
  PLAN_FN int planes() const { return f32 ? 2 : 1; }
  PLAN_FN bool resident() const { return sc == c; }
  PLAN_FN int ns() const { return (c + sc - 1) / sc; }
  PLAN_FN int q_rows() const { return 64 * qg; }
  PLAN_FN int consumers() const { return qg * g; }
  // The consumer warpgroups and, with pw, the producer warp.
  PLAN_FN int threads() const { return 128 * consumers() + 32 * pw; }
  // Registers a thread: ptxas gives each thread a quarter of the file's
  // 65,536 over the warps its scheduler holds (a quarter of the block's,
  // rounded up), in steps of 8, at most 255: 255 with two consumers, 168
  // with two and a producer warp or three, 128 with three and one.
  PLAN_FN int thread_regs() const {
    const int per = REG_LIMIT / 4 / (32 * ((threads() / 32 + 3) / 4)) / 8 * 8;
    return per < 255 ? per : 255;
  }
  PLAN_FN int block_regs() const { return threads() * thread_regs(); }
  // Q resident: its c chunks (both planes at f32) for the block's rows.
  PLAN_FN int q_bytes() const {
    return resident() ? planes() * c * q_rows() * ROW_BYTES : 0;
  }
  // A stage of S: sc chunks of K (and of Q when it streams).
  PLAN_FN int qk_bytes() const {
    return planes() * sc * (bn + (resident() ? 0 : q_rows())) * ROW_BYTES;
  }
  // A stage of P V: the block's g * oc chunks of V's columns for bn keys
  // (at f32, V^T: g * oc * 32 rows of bn keys, both planes).
  PLAN_FN int v_bytes() const { return planes() * g * oc * bn * ROW_BYTES; }
  PLAN_FN int stage_bytes() const {
    return qk_bytes() > v_bytes() ? qk_bytes() : v_bytes();
  }
  // full[stages], empty[stages], q; +1024 to align to the swizzle atom.
  PLAN_FN int smem_bytes() const {
    return q_bytes() + stages * stage_bytes() + 8 * (2 * stages + 1) + 1024;
  }
  // Products done against the useful 4 N^2 Dh: S once a column group and
  // a column block, P V once, over the padded widths.
  PLAN_FN double flop_multiple(int d) const {
    return (2.0 * g * cb * dp() + 2.0 * g * cb * oc * chunk()) / (4.0 * d);
  }
};

// The most stages (up to MAX_STAGES) that fit beside Q.
PLAN_FN Plan fit(Plan p) {
  p.stages = 1;
  int s = MAX_STAGES;
  for (; s > 1; --s) {
    Plan t = p;
    t.stages = s;
    if (t.smem_bytes() <= SMEM_LIMIT) break;
  }
  p.stages = s;
  return p;
}

// Q resident where it leaves room for two stages, else streamed in slabs.
PLAN_FN Plan resident_or_streamed(Plan p, int slab) {
  Plan r = p;
  r.sc = r.c;
  r.stages = 2;
  if (r.smem_bytes() <= SMEM_LIMIT) return fit(r);
  p.sc = slab < p.c ? slab : p.c;
  return fit(p);
}

PLAN_FN int cdiv(int a, int b) { return (a + b - 1) / b; }

// The plan of head dim d >= 1 (64 runs csrc/attention.cu and
// csrc/attention_f32.cu; plan(64, .) is what this kernel would run there).
PLAN_FN Plan plan(int d, int f32) {
  if (!f32) {
    const int c = cdiv(d, 64);
    // {f32, c, qg, g, oc, cb, bn, sc, stages, pw}: a producer warp where
    // the consumers fit 168 registers a thread (O of at most 3 chunks);
    // else consumer thread 0 loads (on an H100 at oc = 4 a producer warp
    // spilled 1.2-2.6 KB a thread and was 3.6x slower).
    if (c == 1) return fit(Plan{0, 1, 3, 1, 1, 1, 128, 1, 1, 0});
    if (c == 2) return fit(Plan{0, 2, 2, 1, 2, 1, 128, 2, 1, 1});
    if (c <= 4) return fit(Plan{0, c, 2, 1, c, 1, 64, c, 1, c < 4});
    const int oc = c <= 8 ? cdiv(c, 2) : 4;
    return resident_or_streamed(
        Plan{0, c, 1, 2, oc, cdiv(c, 2 * oc), 64, c, 1, oc < 4}, BF16_SLAB);
  }
  // f32: always a producer warp (consumer thread 0's loads were 1.25-1.55x
  // slower at every head dim, spills of up to 0.4 KB a thread included).
  const int c = cdiv(d, 32);
  if (c <= 2) return fit(Plan{1, c, 2, 1, c, 1, 64, c, 1, 1});
  if (c <= 4) return fit(Plan{1, c, 2, 1, c, 1, 32, c, 1, 1});
  const int oc = c <= 8 ? cdiv(c, 2) : 4;
  return resident_or_streamed(
      Plan{1, c, 1, 2, oc, cdiv(c, 2 * oc), 32, c, 1, 1}, F32_SLAB);
}

}  // namespace attn_any
