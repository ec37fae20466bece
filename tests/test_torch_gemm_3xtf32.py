"""PyTorch port, rows 5, 6, 8, 9 and 10 at f32 on the 3xTF32 wgmma GEMM
core (csrc/tf32x3_gemm.cuh, csrc/qkv_f32.cu, csrc/mlp_f32.cu,
csrc/swiglu_f32.cu): its arithmetic, on the CPU.

The kernels (TMA, mbarriers, wgmma) run only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 8). What they compute is
held here:
(a) g++ builds csrc/tf32x3.cuh as it is: the port's torch split
    (mlp.tf32x3_split_plain, which chip_smoke.py's selection checks use)
    is its split() bit for bit, and the weights' split planes
    (mlp.tf32x3_weight_plain) hold the rows tf32x3::gated_row names;
(b) a torch model of the core (A and the weights split by that split, per
    32-wide stage a fresh sum of its twelve k8 products, lo.hi and hi.lo
    first, then hi.hi, each added to the accumulator and truncated to f32
    as the tensor core's f32 sum is; that sum added into f32 running sums) stays within chip_smoke.py's f32 bound (F32_MAX_ULPS, its
    f32_exact_check) of the plain stages evaluated on f64 operands and of
    the f32 plain stages, for row 10 at D = 1536, H = 4096, rows 8 and 9
    at D = 384, 768 and 1024 and rows 5 and 6 at D = 384 and 768, each
    product at its full K on 256 rows and 64 of its columns (columns are
    independent sums; row 5's 32 of q's and 32 of k's);
(c) the same model on TF32 operands (one product, no lo) fails that bound;
(d) the model's chains (row 1's LN plain, the products by the model, the
    epilogues by csrc/epilogue_f32.cuh built with g++) hold against the JAX
    package's mlp_residual_pallas, swiglu_residual_pallas, ln_qkv_pallas
    and proj_ls_residual_pallas at f32 in interpret mode, at small widths,
    within those tests' f32 bounds;
(e) the wgmma m64n128 accumulator hands a thread columns c and c + 64,
    which the gated planes fill with x1 and x2 of one hidden column, the
    column SwigluGate stores (and not without the permutation);
(f) the epilogues' per-element functions (csrc/epilogue_f32.cuh, built by
    g++ over tests/cuda_emu/cuda_runtime.h) against the plain versions;
(g) a selection product (w rows picking one input column) gives hi(a) +
    lo(a) exactly: a itself on every bf16 value, what chip_smoke.py's GELU
    and silu checks feed the eager chains. Needs g++.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (F32_MAX_ULPS, f32_exact_check, f32_ulps, f64,
                        tf32_round)
from tests.test_torch_attention_3xtf32 import _patterns
from vr_video_generator_tpu.ops.mlp_pallas import (mlp_residual_pallas,
                                                   swiglu_residual_pallas)
from vr_video_generator_tpu.ops.qkv_pallas import (ln_qkv_pallas,
                                                   proj_ls_residual_pallas)
from vr_video_generator_tpu_torch.kernels.build import CSRC_DIR
from vr_video_generator_tpu_torch.ops import mlp
from vr_video_generator_tpu_torch.ops.gelu import gelu_exact, gelu_tanh
from vr_video_generator_tpu_torch.ops.layernorm import layernorm_plain
from vr_video_generator_tpu_torch.ops.qkv import (proj_ls_residual_plain,
                                                  qkv_plain)

torch.set_num_threads(2)
torch.set_grad_enabled(False)

EMU_DIR = Path(__file__).resolve().parent / "cuda_emu"
SUM_K = 32  # csrc/tf32x3_gemm.cuh BK: K a stage, one fresh tensor-core sum
K_STEP = 8  # wgmma .tf32's k
UNIT = """#include <cuda_runtime.h>
namespace {
alignas(16) unsigned char smem[16];
}
namespace emu {
static unsigned char* shared_memory() { return smem; }
}
#include "tf32x3.cuh"
#include "epilogue_f32.cuh"
extern "C" void split_many(const uint32_t* x, uint32_t* hi, uint32_t* lo,
                           long n) {
  for (long i = 0; i < n; ++i) {
    tf32x3::split(tf32x3::from_bits(x[i]), hi[i], lo[i]);
  }
}
extern "C" int gated_row(int p, int hidden) {
  return tf32x3::gated_row(p, hidden);
}
extern "C" void bias_gelu_many(const float* s, const float* b, float* out,
                               long n, int tanh) {
  for (long i = 0; i < n; ++i) {
    out[i] = tanh ? vrvg::bias_gelu_f32<true>(s[i], b[i])
                  : vrvg::bias_gelu_f32<false>(s[i], b[i]);
  }
}
extern "C" void ls_residual_many(const float* s, const float* b,
                                 const float* g, const float* x, float* out,
                                 long n) {
  for (long i = 0; i < n; ++i) {
    out[i] = vrvg::ls_residual_f32(s[i], b[i], g[i], x[i]);
  }
}
extern "C" void qkv_many(const float* s, const float* b, const float* q,
                         float* out, long n, float scale) {
  for (long i = 0; i < n; ++i) {
    out[i] = vrvg::qkv_f32(s[i], b[i], scale, q[i] != 0.f);
  }
}
extern "C" void swiglu_gate_many(const float* s1, const float* b1,
                                 const float* s2, const float* b2, float* out,
                                 long n) {
  for (long i = 0; i < n; ++i) {
    out[i] = vrvg::swiglu_gate_f32(s1[i], b1[i], s2[i], b2[i]);
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build csrc/tf32x3.cuh")
    tmp = tmp_path_factory.mktemp("tf32x3_gemm")
    (tmp / "unit.cpp").write_text(UNIT)
    so = tmp / "libtf32x3_gemm.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         "-ffp-contract=off", "-w", f"-I{CSRC_DIR}", f"-I{EMU_DIR}",
         str(tmp / "unit.cpp"), "-o", str(so)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = ctypes.CDLL(str(so))
    P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    out.split_many.argtypes = [P, P, P, L]
    out.gated_row.argtypes = [I, I]
    out.gated_row.restype = I
    out.bias_gelu_many.argtypes = [P, P, P, L, I]
    out.ls_residual_many.argtypes = [P] * 5 + [L]
    out.swiglu_gate_many.argtypes = [P] * 5 + [L]
    out.qkv_many.argtypes = [P] * 4 + [L, ctypes.c_float]
    for fn in (out.split_many, out.bias_gelu_many, out.ls_residual_many,
               out.swiglu_gate_many, out.qkv_many):
        fn.restype = None
    return out


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def elementwise(lib, name, *tensors, **kw):
    """An epilogue function of the g++ unit over f32 tensors of one shape."""
    ts = [t.contiguous().float() for t in tensors]
    out = torch.empty_like(ts[0])
    fn = getattr(lib, name)
    extra = ((int(kw["tanh"]),) if "tanh" in kw
             else (kw["scale"],) if "scale" in kw else ())
    fn(*map(_ptr, ts), _ptr(out), ts[0].numel(), *extra)
    return out


# --- the model of the core -------------------------------------------------

def trunc_f32(x: torch.Tensor) -> torch.Tensor:
    """f64 values to f32 rounded toward zero."""
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def core_sums(a: torch.Tensor, planes: torch.Tensor, products="3xtf32",
              span=SUM_K) -> torch.Tensor:
    """A (M, K) f32 times the split weight ``planes`` (2, N, K) as
    csrc/tf32x3_gemm.cuh sums it: A split by tf32x3::split; per ``span``
    columns of K a fresh tensor-core sum of their k8 products, lo.hi and
    hi.lo at each k-step, then hi.hi at each (each product of 8 terms added
    to the accumulator exactly and the result truncated to f32); that sum
    added into f32 running sums. ``products``:
    "3xtf32" (the kernel), or "tf32" (A and the weight rounded to TF32, one
    product a k-step)."""
    if products == "tf32":
        ah, al = mlp.tf32_rna(a), torch.zeros_like(a)
        bh, bl = mlp.tf32_rna(planes[0] + planes[1]), torch.zeros_like(planes[0])
    else:
        ah, al = mlp.tf32x3_split_plain(a)
        bh, bl = planes[0], planes[1]
    ah, al, bh, bl = f64(ah, al, bh, bl)
    k = a.shape[1]
    total = torch.zeros((a.shape[0], planes.shape[1]))
    for s0 in range(0, k, span):
        steps = range(s0, min(s0 + span, k), K_STEP)
        seq = [p for kk in steps for p in ((al, bh, kk), (ah, bl, kk))]
        seq += [(ah, bh, kk) for kk in steps]
        acc = torch.zeros((a.shape[0], planes.shape[1]), dtype=torch.float64)
        for x, y, kk in seq:
            acc = trunc_f32(acc + x[:, kk:kk + K_STEP]
                            @ y[:, kk:kk + K_STEP].T).double()
        total = total + acc.float()
    return total


def seeded(rng, shape, scale=1.0, shift=0.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale + shift).astype(np.float32))


ROWS, COLS = 256, 64  # of each product, at its full K

# (stage, D): the products of rows 8 and 9 (fc1: K = D; fc2: K = 4D) at
# vits', vitb's and vitl's widths, row 10's gate (K = 1536) and down
# product (K = 4096), and rows 5 and 6 (qkv, proj: K = D) at vits' and
# vitb's, where the JAX package fuses the attention half at f32.
CASES = [("fc1", 384), ("fc2", 384), ("fc1", 768), ("fc2", 768),
         ("fc1", 1024), ("fc2", 1024), ("gate", 1536), ("down", 1536),
         ("qkv", 384), ("qkv", 768), ("proj", 384), ("proj", 768)]
SCALE = 64 ** -0.5  # q's scale at head dim 64
IDS = [f"{stage} D={d}" for stage, d in CASES]


def stage_case(lib, stage: str, d: int, products="3xtf32"):
    """One stage on seeded operands of chip_smoke.py's scales: (its output
    by the model, by the plain version on f64 operands, by the f32 plain
    version, by the f32 plain version with the weight rounded to TF32, the
    scale's addends)."""
    rng = np.random.default_rng(sum(map(ord, stage)) + d)
    if stage == "qkv":
        return qkv_case(lib, rng, d, products)
    if stage == "proj":
        return proj_case(lib, rng, d, products)
    if stage == "fc1":
        a = seeded(rng, (ROWS, d), 1.0)
        w, b = seeded(rng, (COLS, d), d ** -0.5), seeded(rng, (COLS,), 0.5)
        got = elementwise(lib, "bias_gelu_many",
                          core_sums(a, mlp.tf32x3_weight_plain(w),
                                    products)[:, :COLS],
                          b.expand(ROWS, COLS), tanh=False)
        return (got, mlp.fc1_gelu_plain(*f64(a, w, b)),
                mlp.fc1_gelu_plain(a, w, b),
                mlp.fc1_gelu_plain(a, tf32_round(w), b), (a @ w.T + b,))
    if stage in ("fc2", "down"):
        k = 4 * d if stage == "fc2" else mlp.swiglu_hidden(d)
        h = seeded(rng, (ROWS, k), 0.5)
        w, b = seeded(rng, (COLS, k), k ** -0.5), seeded(rng, (COLS,), 0.5)
        g, x = seeded(rng, (COLS,), 0.1, 1.0), seeded(rng, (ROWS, COLS))
        sums = core_sums(h, mlp.tf32x3_weight_plain(w), products)[:, :COLS]
        got = elementwise(lib, "ls_residual_many", sums, b.expand_as(sums),
                          g.expand_as(sums), x)
        return (got, mlp.fc2_residual_plain(*f64(h, w, b, g, x)),
                mlp.fc2_residual_plain(h, w, b, g, x),
                mlp.fc2_residual_plain(h, tf32_round(w), b, g, x),
                (x, g * b))
    # Row 10's gate on 32 hidden columns: 64 GEMM columns of the gated
    # planes, x1 and x2 of each.
    hid = mlp.swiglu_hidden(d)
    h = seeded(rng, (ROWS, d), 1.0)
    w12 = torch.zeros((2 * hid, d))
    b12 = torch.zeros(2 * hid)
    cols = torch.cat([torch.arange(COLS // 2), hid + torch.arange(COLS // 2)])
    w12[cols] = seeded(rng, (COLS, d), d ** -0.5)
    b12[cols] = seeded(rng, (COLS,), 0.5)
    planes = mlp.tf32x3_weight_plain(w12, hid)[:, :128]
    sums = core_sums(h, planes, products)
    got = elementwise(lib, "swiglu_gate_many", sums[:, :COLS // 2],
                      b12[:COLS // 2].expand(ROWS, -1), sums[:, 64:96],
                      b12[hid:hid + COLS // 2].expand(ROWS, -1))
    sub = (w12[cols], b12[cols])
    t = h @ sub[0].T + sub[1]
    return (got, mlp.swiglu_gate_plain(*f64(h, *sub)),
            mlp.swiglu_gate_plain(h, *sub),
            mlp.swiglu_gate_plain(h, tf32_round(sub[0]), sub[1]),
            ((t[:, :COLS // 2] * t[:, COLS // 2:]).abs(),))


def qkv_case(lib, rng, d: int, products: str):
    """Row 5's product stage (the qkv product + bias, q scaled) on
    LayerNorm'd rows, 32 of q's columns and 32 of k's; the references
    qkv_plain's on all 3D columns."""
    heads = d // 64
    a = seeded(rng, (ROWS, d), 1.0)
    w, b = seeded(rng, (3 * d, d), d ** -0.5), seeded(rng, (3 * d,), 0.5)
    cols = torch.cat([torch.arange(COLS // 2), d + torch.arange(COLS // 2)])
    is_q = (cols < d).float()
    sums = core_sums(a, mlp.tf32x3_weight_plain(w[cols]), products)[:, :COLS]
    got = elementwise(lib, "qkv_many", sums, b[cols].expand_as(sums),
                      is_q.expand_as(sums), scale=SCALE)

    def picked(*args):
        t = qkv_plain(args[0].reshape(1, ROWS, d), *args[1:], heads, SCALE)
        return t.reshape(ROWS, 3 * d)[:, cols]

    bias = torch.where(is_q > 0, b[cols] * SCALE, b[cols])
    return (got, picked(*f64(a, w, b)), picked(a, w, b),
            picked(a, tf32_round(w), b), (bias,))


def proj_case(lib, rng, d: int, products: str):
    """Row 6 (the proj product + bias, LayerScale, the residual) on the
    attention output's rows, its first 64 columns; the references
    proj_ls_residual_plain's on all D columns."""
    o = seeded(rng, (ROWS, d), 1.0)
    w, b = seeded(rng, (d, d), d ** -0.5), seeded(rng, (d,), 0.5)
    g, x = seeded(rng, (d,), 0.1, 1.0), seeded(rng, (ROWS, d))
    sums = core_sums(o, mlp.tf32x3_weight_plain(w[:COLS]), products)[:, :COLS]
    got = elementwise(lib, "ls_residual_many", sums, b[:COLS].expand_as(sums),
                      g[:COLS].expand_as(sums), x[:, :COLS])

    def picked(o, x, w, b, g):
        return proj_ls_residual_plain(o.reshape(1, ROWS, d // 64, 64),
                                      x.reshape(1, ROWS, d), w, b,
                                      g).reshape(ROWS, d)[:, :COLS]

    return (got, picked(*f64(o, x, w, b, g)), picked(o, x, w, b, g),
            picked(o, x, tf32_round(w), b, g), (x[:, :COLS], (g * b)[:COLS]))


# --- (a) the split -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "every exponent", "ties",
                                  "subnormals", "largest finite",
                                  "inf and nan"])
def test_torch_split_is_the_header_split(lib, kind):
    """mlp.tf32x3_split_plain gives csrc/tf32x3.cuh's split() bit for bit
    (NaN as NaN), on edge and random bit patterns."""
    u = _patterns(kind)
    hi, lo = np.empty_like(u), np.empty_like(u)
    lib.split_many(u.ctypes.data, hi.ctypes.data, lo.ctypes.data, u.size)
    th, tl = mlp.tf32x3_split_plain(torch.from_numpy(u.view(np.float32)))
    for got, want in ((th, hi), (tl, lo)):
        got = got.numpy()
        nan = np.isnan(want.view(np.float32))
        assert np.array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(got.view(np.uint32)[~nan], want[~nan])


@pytest.mark.parametrize("rows,hidden", [(200, 0), (256, 128), (400, 200),
                                         (688, 344)])
def test_weight_planes_hold_the_header_rows(lib, rows, hidden):
    """tf32x3_weight_plain's planes (what split_kernel writes): row p of
    each holds the weight's row p (plain; zeros past N, N rounded up to
    128) or tf32x3::gated_row(p, H) (gated; zeros past H), split; the two
    planes sum to the weight within 2^-22 of each value."""
    rng = np.random.default_rng(rows + hidden)
    w = seeded(rng, (rows, 40))
    planes = mlp.tf32x3_weight_plain(w, hidden)
    n = mlp.tf32x3_rows(rows, hidden)
    assert planes.shape == (2, n, 40) and n % 128 == 0
    src = [lib.gated_row(p, hidden) if hidden else (p if p < rows else -1)
           for p in range(n)]
    if hidden:
        assert mlp.gated_rows(hidden).tolist() == src
    for p, r in enumerate(src):
        if r < 0:
            assert not planes[:, p].any()
        else:
            hi, lo = mlp.tf32x3_split_plain(w[r])
            assert torch.equal(planes[0, p], hi) and torch.equal(planes[1, p],
                                                                 lo)
    got = planes[0] + planes[1]
    live = torch.tensor([r >= 0 for r in src])
    want = w[torch.tensor(src)[live]]
    assert ((got[live] - want).abs() <= 2.0 ** -22 * want.abs()).all()


# --- (b), (c) the model against the bounds ----------------------------------

@pytest.mark.parametrize("stage,d", CASES, ids=IDS)
def test_core_model_within_the_f32_bounds(lib, stage, d):
    """(b) The model within F32_MAX_ULPS of the plain stage on f64 operands
    (chip_smoke.f32_exact_check: the TF32-rounded weight refused, the model
    at least as close to that reference on average as the f32 plain
    version) and of the f32 plain stage."""
    got, exact, plain, tf32_want, addends = stage_case(lib, stage, d)
    stats = f32_exact_check(f"{stage} D={d}", got, exact, plain, tf32_want,
                            1, *addends)
    assert stats["vs_plain_max_ulps"] <= F32_MAX_ULPS, stats
    print(stats)


@pytest.mark.parametrize("stage,d", CASES, ids=IDS)
def test_tf32_model_fails_the_f32_bounds(lib, stage, d):
    """(c) The model on TF32 operands (one product a k-step) is outside
    F32_MAX_ULPS of the f64 reference, as the card's TF32 result must be."""
    got, exact, _, _, addends = stage_case(lib, stage, d, products="tf32")
    tf32 = f32_ulps(got, exact, 1, *addends)
    print(f"{stage} D={d}: TF32 model {tf32.max().item():.1f} ulps at most, "
          f"{tf32.mean().item():.2f} on average")
    assert tf32.max().item() > F32_MAX_ULPS


# --- (d) the model's chains against the JAX package -------------------------

def _jax(fn, x, params, **kw):
    return torch.from_numpy(np.array(fn(
        jnp.asarray(x), **{k: jnp.asarray(v) for k, v in params.items()},
        interpret=True, **kw)))


def model_mlp(lib, x, lnw, lnb, w1, b1, w2, b2, gamma, approx=False):
    """Rows 8 and 9 at f32 as csrc/mlp_f32.cu chains them: LN, fc1 on the
    core + b1 + GELU (the g++ epilogue), fc2 on the core + b2, LayerScale,
    residual."""
    a = layernorm_plain(x, lnw, lnb)
    t = core_sums(a, mlp.tf32x3_weight_plain(w1))
    h = elementwise(lib, "bias_gelu_many", t, b1.expand_as(t), tanh=approx)
    y = core_sums(h, mlp.tf32x3_weight_plain(w2))
    return elementwise(lib, "ls_residual_many", y, b2.expand_as(y),
                       gamma.expand_as(y), x)


def model_swiglu(lib, x, lnw, lnb, w12, b12, w3, b3, gamma):
    """Row 10 at f32 as csrc/swiglu_f32.cu chains it, the gate on the gated
    planes (a tile's 64 x1 and 64 x2 columns)."""
    hid = w12.shape[0] // 2
    h = layernorm_plain(x, lnw, lnb)
    t = core_sums(h, mlp.tf32x3_weight_plain(w12, hid))
    tiles = t.reshape(len(x), -1, 2, 64)
    x1 = tiles[:, :, 0].reshape(len(x), -1)[:, :hid]
    x2 = tiles[:, :, 1].reshape(len(x), -1)[:, :hid]
    g = elementwise(lib, "swiglu_gate_many", x1, b12[:hid].expand_as(x1), x2,
                    b12[hid:].expand_as(x2))
    y = core_sums(g, mlp.tf32x3_weight_plain(w3))
    return elementwise(lib, "ls_residual_many", y, b3.expand_as(y),
                       gamma.expand_as(y), x)


def _params(rng, d, hid, gated):
    """Seeded half-block parameters in the JAX package's layout."""
    p = dict(ln_scale=(1.0 + 0.1 * rng.standard_normal(d)),
             ln_bias=0.1 * rng.standard_normal(d))
    if gated:
        p.update(w12=rng.standard_normal((d, 2 * hid)) * d ** -0.5,
                 b12=0.1 * rng.standard_normal(2 * hid),
                 w3=rng.standard_normal((hid, d)) * hid ** -0.5,
                 b3=0.1 * rng.standard_normal(d))
    else:
        p.update(w1=rng.standard_normal((d, hid)) * d ** -0.5,
                 b1=0.1 * rng.standard_normal(hid),
                 w2=rng.standard_normal((hid, d)) * hid ** -0.5,
                 b2=0.1 * rng.standard_normal(d))
    p["gamma"] = 1.0 + 0.1 * rng.standard_normal(d)
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("half,d,m,approx", [
    ("mlp", 128, 100, False), ("mlp", 128, 100, True), ("mlp", 384, 40, False),
    ("swiglu", 128, 60, False)],
    ids=["row 8 D=128", "row 8 D=128 tanh", "row 8 D=384", "row 10 D=128"])
def test_model_chain_matches_pallas_interpret(lib, half, d, m, approx):
    """(d) The model's chain against mlp_residual_pallas (f32, within the
    JAX tests' 2e-5) or swiglu_residual_pallas (f32, within 64 ulps of max
    |out|, tests/test_torch_f32_swiglu.py's bound), in interpret mode."""
    gated = half == "swiglu"
    hid = mlp.swiglu_hidden(d) if gated else 4 * d
    rng = np.random.default_rng(d + m + approx + 7 * gated)
    x = (rng.standard_normal((m, d)) * 0.5).astype(np.float32)
    p = _params(rng, d, hid, gated)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()}
    xt = torch.from_numpy(x)
    if gated:
        ref = _jax(swiglu_residual_pallas, x, p)
        got = model_swiglu(lib, xt, t["ln_scale"], t["ln_bias"], t["w12"].T,
                           t["b12"], t["w3"].T, t["b3"], t["gamma"])
        ulp = 2.0 ** (np.floor(np.log2(ref.abs().max().item())) - 23)
        assert (got - ref).abs().max().item() <= 64 * ulp
    else:
        ref = _jax(mlp_residual_pallas, x, p, approx=approx)
        got = model_mlp(lib, xt, t["ln_scale"], t["ln_bias"], t["w1"].T, t["b1"],
                        t["w2"].T, t["b2"], t["gamma"], approx)
        assert (got - ref).abs().max().item() <= 2e-5


def model_ln_qkv(lib, x, lnw, lnb, w, b, heads, scale):
    """Row 5 at f32 as csrc/qkv_f32.cu chains it: LN, then the qkv product
    on the core, + b, q's columns (below D) times scale (the g++
    epilogue): (B, N, 3, heads, 64)."""
    bsz, n, d = x.shape
    t = core_sums(layernorm_plain(x, lnw, lnb).reshape(-1, d),
                  mlp.tf32x3_weight_plain(w))[:, :3 * d]
    is_q = (torch.arange(3 * d) < d).float()
    out = elementwise(lib, "qkv_many", t, b.expand_as(t), is_q.expand_as(t),
                      scale=scale)
    return out.reshape(bsz, n, 3, heads, d // heads)


def model_proj(lib, o, x, w, b, gamma):
    """Row 6 at f32 as csrc/qkv_f32.cu runs it: the proj product of the
    attention output (B, N, H, 64) on the core, + b, LayerScale, residual."""
    d = x.shape[-1]
    y = core_sums(o.reshape(-1, d), mlp.tf32x3_weight_plain(w))[:, :d]
    xs = x.reshape(-1, d)
    return elementwise(lib, "ls_residual_many", y, b.expand_as(y),
                       gamma.expand_as(y), xs).reshape(x.shape)


@pytest.mark.parametrize("row", [5, 6])
def test_model_qkv_chains_match_pallas_interpret(lib, row):
    """(d) Rows 5 and 6 at f32, D = 128 (2 heads), as the model chains them,
    against ln_qkv_pallas (q, k, v in its (B, H, N_pad, 64) layout, pads
    dropped) and proj_ls_residual_pallas in interpret mode within 2e-5 (the
    JAX tests' f32 bound); N = 100, not a multiple of a token block."""
    d, heads, bsz, n = 128, 2, 2, 100
    rng = np.random.default_rng(row + d)
    x = rng.standard_normal((bsz, n, d)).astype(np.float32)
    if row == 5:
        lnw = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
        lnb = (0.1 * rng.standard_normal(d)).astype(np.float32)
        w = (rng.standard_normal((3 * d, d)) * d ** -0.5).astype(np.float32)
        b = (0.1 * rng.standard_normal(3 * d)).astype(np.float32)
        qt, kt, vt = ln_qkv_pallas(*(jnp.asarray(v) for v in (
            x, lnw, lnb, np.ascontiguousarray(w.T), b)), heads, SCALE,
            interpret=True)
        ref = torch.from_numpy(np.stack(
            [np.asarray(t)[:, :, :n].transpose(0, 2, 1, 3)
             for t in (qt, kt, vt)], axis=2))
        got = model_ln_qkv(lib, *map(torch.from_numpy, (x, lnw, lnb, w, b)),
                           heads, SCALE)
    else:
        o = rng.standard_normal((bsz, n, heads, 64)).astype(np.float32)
        w = (rng.standard_normal((d, d)) * d ** -0.5).astype(np.float32)
        b = (0.1 * rng.standard_normal(d)).astype(np.float32)
        gamma = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
        ref = torch.from_numpy(np.array(proj_ls_residual_pallas(*(
            jnp.asarray(v) for v in (np.ascontiguousarray(
                o.transpose(0, 2, 1, 3)), x, np.ascontiguousarray(w.T), b,
                gamma)), interpret=True)))
        got = model_proj(lib, *map(torch.from_numpy, (o, x, w, b, gamma)))
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= 2e-5


# --- (e) the accumulator's columns and the gated planes ----------------------

def accumulator_columns(thread: int):
    """The GEMM columns (of a 128-column tile) of a wgmma m64n128 f32
    accumulator's values 4 j + 2 i + c that thread (warp w, lane l) holds:
    8 j + 2 (l % 4) + c, j = 0..15 (PTX ISA wgmma D layout)."""
    quad = thread % 32 % 4
    return {4 * j + 2 * i + c: 8 * j + 2 * quad + c
            for j in range(16) for i in range(2) for c in range(2)}


@pytest.mark.parametrize("hidden", [128, 200, 344])
def test_gated_planes_pair_x1_and_x2_in_a_thread(lib, hidden):
    """(e) With the planes in gated_row's order, the values j and j + 8 of a
    thread's accumulator are x1 and x2 of one hidden column, the column
    SwigluGate stores (n0 / 2 + 8 j + 2 quad + c); w12's rows in their own
    order would pair x1 with x1."""
    tiles = mlp.tf32x3_rows(2 * hidden, hidden) // 128
    for order in ("gated", "w12's"):
        pairs = True
        for tile in range(tiles):
            for thread in range(128):
                cols = accumulator_columns(thread)
                for j in range(8):
                    for c in range(2):
                        c1 = tile * 128 + cols[4 * j + c]
                        c2 = tile * 128 + cols[4 * (j + 8) + c]
                        store = tile * 64 + cols[4 * j + c]
                        if store >= hidden:
                            continue
                        r1, r2 = ((lib.gated_row(c1, hidden),
                                   lib.gated_row(c2, hidden))
                                  if order == "gated" else (c1, c2))
                        pairs &= (r1, r2) == (store, hidden + store)
        assert pairs == (order == "gated")


# --- (f) the epilogues' functions --------------------------------------------

def ulps_of(got, want, size):
    ulp = torch.exp2(torch.floor(torch.log2(size.double().clamp_min(
        2.0 ** -126))) - 23)
    return ((got.double() - want.double()).abs() / ulp).max().item()


@pytest.mark.parametrize("kind", ["gelu", "gelu tanh", "ls_residual",
                                  "swiglu_gate", "qkv"])
def test_epilogue_functions_match_plain(lib, kind):
    """(f) csrc/epilogue_f32.cuh's functions (g++, the host's expf and
    tanhf) against the plain versions on seeded values: LayerScale and the
    residual and row 5's + bias, q times scale bit for bit (rounded adds and
    products only); the GELUs and the gate within 2 f32 ulps of their
    operands' scale (expf, tanhf)."""
    rng = np.random.default_rng(len(kind))
    s, b = seeded(rng, (4096,), 3.0), seeded(rng, (4096,), 0.5)
    if kind.startswith("gelu"):
        tanh = kind.endswith("tanh")
        got = elementwise(lib, "bias_gelu_many", s, b, tanh=tanh)
        want = (gelu_tanh if tanh else gelu_exact)(s + b)
        size = torch.maximum((s + b).abs(), want.abs())
        assert ulps_of(got, want, size) <= 2
    elif kind == "ls_residual":
        g, x = seeded(rng, (4096,), 0.1, 1.0), seeded(rng, (4096,))
        got = elementwise(lib, "ls_residual_many", s, b, g, x)
        assert torch.equal(got, x + g * (s + b))
    elif kind == "qkv":
        is_q = (torch.arange(4096) % 3 == 0).float()
        got = elementwise(lib, "qkv_many", s, b, is_q, scale=0.1)
        assert torch.equal(got, torch.where(is_q > 0, (s + b) * 0.1, s + b))
    else:
        s2, b2 = seeded(rng, (4096,), 3.0), seeded(rng, (4096,), 0.5)
        got = elementwise(lib, "swiglu_gate_many", s, b, s2, b2)
        want = mlp.silu_mul(s + b, s2 + b2)
        size = torch.maximum(want.abs(), ((s + b) * (s2 + b2)).abs())
        assert ulps_of(got, want, size) <= 2


# --- (g) a selection product -------------------------------------------------

def test_selection_product_gives_hi_plus_lo():
    """(g) The model of a product whose weight rows pick one input column
    each (w1 = the identity, repeated) gives hi(a) + lo(a) exactly, the sum
    chip_smoke.py's selection checks feed the eager chains: every bf16
    value itself; 2^-22 of a value at most elsewhere."""
    bf = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).float()
    vals = torch.cat([bf[torch.isfinite(bf)],
                      torch.linspace(-8.0, 8.0, 4096)])
    vals = torch.cat([vals, torch.zeros((-len(vals)) % 128)])
    a = vals.reshape(-1, 128)
    sums = core_sums(a, mlp.tf32x3_weight_plain(torch.eye(128)))
    hi, lo = mlp.tf32x3_split_plain(a)
    assert torch.equal(sums, hi + lo)
    n_bf = int(torch.isfinite(bf).sum())
    assert torch.equal(sums.flatten()[:n_bf], vals[:n_bf])
    assert ((sums - a).abs() <= 2.0 ** -22 * a.abs()).all()
