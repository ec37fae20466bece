"""PyTorch port, f32 on the card: the f32 kernels' CUDA sources run on the
CPU under the host emulation of CUDA (tests/cuda_emu/cuda_runtime.h),
against their plain versions.

g++ compiles csrc/qkv_f32.cu (the f32 GEMM core of csrc/sgemm.cuh with row
5's and row 6's epilogues) and csrc/mlp_f32.cu (rows 8 and 9 at f32: fc1
with b1 and the GELU of csrc/gelu_as.cuh, fc2 with b2, LayerScale and the residual),
csrc/swiglu_f32.cu (row 10 at f32: the gate with w12 as the gated operand
sgemm::GatedRows, b12 and silu(x1) * x2 in its epilogue, the down product
with b3, LayerScale and the residual) and csrc/rcu_pair_f32.cu (row 16 at
f32: the ReLU pass and each conv of the chain with its bias, ReLU,
residuals and ReLU'd copy) as they are,
launches rewritten to the emulator's, and a unit that instantiates the core
with the f32 DPT tails' operands (csrc/sconv.cuh: the 3x3 conv as an
implicit GEMM, conv1's bias and bias-free stores, conv2's depth epilogue,
and the tile each product takes by width) as vrvg_head_tail_ext_f32,
vrvg_head_tail_big_f32 and vrvg_head_tail_f32 (row 15 at f32) call them; the tails' passes (upsample, resize) are
their plain versions around them. Each CUDA thread is a std::thread and each
__syncthreads a barrier, so the tiles' indexing, the ragged edges and the
double-buffered k slices run as written. Rows 2 and 17 at f32
(csrc/attention_f32.cu: TMA and wgmma, which the emulation has not) are
held on the CPU by tests/test_torch_attention_3xtf32.py. The plain
versions sum in another order, so each output is held to a bound in f32
ulps of its scale (the f32 sums' reordering: a few ulps; a TF32 product
would be thousands off); the GELU epilogue's expf and tanhf are the host's,
so the fc1 stage (and row 10's gate, its silu's expf) is held to the
same bound, not bit for bit (the card holds
it bit for bit against the eager chain). This checks logic only; the card checks the
kernels themselves (chip_smoke.py phase 8). Needs g++ (C++20).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vr_video_generator_tpu_torch.kernels.build import CSRC_DIR, SIGNATURES
from vr_video_generator_tpu_torch.ops import head_tail as ht
from vr_video_generator_tpu_torch.ops import mlp
from vr_video_generator_tpu_torch.ops.head_tail import (big_conv2_plain,
                                                        conv3x3_gemm_weights,
                                                        ext_conv1_plain,
                                                        ext_mix_plain)
from vr_video_generator_tpu_torch.ops.qkv import (proj_ls_residual_plain,
                                                  qkv_plain)

torch.set_num_threads(2)

EMU_DIR = Path(__file__).resolve().parent / "cuda_emu"
UNIT = """#include <cuda_runtime.h>
namespace {
alignas(1024) unsigned char smem[emu::SHARED_BYTES];
}
namespace emu {
static unsigned char* shared_memory() { return smem; }
}
%s
#include "%s"
%s
"""
# qkv_f32.cu's chain calls row 1's f32 LayerNorm (csrc/layernorm.cu, warp
# shuffles, not emulated); this stand-in reports an error, which the chain
# must pass on.
LN_STUB = """extern "C" int vrvg_layernorm_f32(const void*, const void*,
                                  const void*, void*, int, int, float,
                                  void*) { return 77; }"""
# The f32 tail's three products as vrvg_head_tail_ext_f32 runs them.
TAIL_ENTRIES = """
extern "C" int emu_mix_f32(const float* x, const float* koc, float* xoc,
                           int m, int c) {
  return sgemm::gemm<sgemm::Tall64>(sgemm::DenseRows{x, c, m, c},
                                    sgemm::DenseRows{koc, c, c, c}, m, c, c,
                                    sgemm::Store{xoc, c}, nullptr);
}
extern "C" int emu_conv1_f32(const float* z, const float* w1, const float* b1,
                             float* c1, int batch, int h, int w, int c,
                             int c2) {
  const int m = batch * h * w;
  return sgemm::gemm<sgemm::Rows32>(
      sgemm::Conv3x3Rows{z, h, w, c, m},
      sgemm::DenseRows{w1, 9 * c, c2, 9 * c}, m, c2, 9 * c,
      sgemm::BiasStore{c1, b1, c2}, nullptr);
}
extern "C" int emu_conv2_depth_f32(const float* r, const float* w2,
                                   const float* b2, const float* w3,
                                   const float* b3, float* out, int batch,
                                   int h, int w, int c2) {
  const int m = batch * h * w;
  return sgemm::gemm<sgemm::Rows32>(
      sgemm::Conv3x3Rows{r, h, w, c2, m},
      sgemm::DenseRows{w2, 9 * c2, 32, 9 * c2}, m, 32, 9 * c2,
      sgemm::DepthOut{out, b2, w3, b3}, nullptr);
}
// The same products as both f32 tails' entry points run them, on the tile
// csrc/sconv.cuh picks by width: the mix, a conv3x3 with or without its
// bias (row 7's conv1 / row 11's folded conv1), conv2 with the 1x1.
extern "C" int emu_mix_n_f32(const float* x, const float* koc, float* xoc,
                             int m, int c) {
  return sgemm::gemm_n(sgemm::DenseRows{x, c, m, c}, koc, m, c, c,
                       sgemm::Store{xoc, c}, nullptr);
}
extern "C" int emu_conv3x3_f32(const float* x, const float* w,
                               const float* bias, float* out, int batch,
                               int h, int wd, int c, int n) {
  if (bias != nullptr) {
    return sgemm::conv3x3(x, w, batch, h, wd, c, n,
                          sgemm::BiasStore{out, bias, n}, nullptr);
  }
  return sgemm::conv3x3(x, w, batch, h, wd, c, n, sgemm::Store{out, n},
                        nullptr);
}
extern "C" int emu_conv2_depth_n_f32(const float* r, const float* w2,
                                     const float* b2, const float* w3,
                                     const float* b3, float* out, int batch,
                                     int h, int w, int c2) {
  return sgemm::conv2_depth(r, w2, b2, w3, b3, out, batch, h, w, c2,
                            nullptr);
}
"""
UNITS = {"qkv_f32.cu": ("", "qkv_f32.cu", LN_STUB),
         "tail_f32.cpp": ("", "sconv.cuh", TAIL_ENTRIES)}
_P, _I = ctypes.c_void_p, ctypes.c_int
EMU_SIGNATURES = {
    "emu_mix_f32": [_P, _P, _P, _I, _I],
    "emu_conv1_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I],
    "emu_conv2_depth_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I],
    "emu_mix_n_f32": [_P, _P, _P, _I, _I],
    "emu_conv3x3_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I],
    "emu_conv2_depth_n_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I],
}
# mlp_f32.cu's chain starts with row 1's f32 LayerNorm (csrc/layernorm.cu,
# not emulated): in its own library this stand-in computes it on the host
# (f64 statistics, f32 output), so the chain runs whole.
LN_HOST = """#include <math.h>
extern "C" int vrvg_layernorm_f32(const void* x, const void* w,
                                  const void* b, void* y, int m, int d,
                                  float eps, void*) {
  for (int r = 0; r < m; ++r) {
    const float* xr = (const float*)x + (long long)r * d;
    float* yr = (float*)y + (long long)r * d;
    double s = 0, v = 0;
    for (int i = 0; i < d; ++i) s += xr[i];
    const double mean = s / d;
    for (int i = 0; i < d; ++i) v += (xr[i] - mean) * (xr[i] - mean);
    const double rstd = 1.0 / sqrt(v / d + eps);
    for (int i = 0; i < d; ++i)
      yr[i] = (float)((xr[i] - mean) * rstd) * ((const float*)w)[i] +
              ((const float*)b)[i];
  }
  return 0;
}"""
# Bounds in f32 ulps of each output's scale (the largest of the output, its
# feature's RMS and its addends): f32 sums in another order than the plain
# version's.
MAX_ULPS = 64


def emulated(text: str) -> str:
    """kernel<<<grid, block, smem, stream>>>(...) -> the emulator's launch."""
    return re.sub(r"(\w+(?:<[\w\s,]+>)?)\s*<<<(.*?)>>>\(",
                  r"emu::Launch(\2)(\1, ", text, flags=re.S)


def _build(tmp, units, entries, name):
    """g++ the emulated sources and ``units`` ({file: (pre, include, post)})
    into one library; bind ``entries`` (SIGNATURES' and EMU_SIGNATURES')."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build the CUDA emulation")
    for src in ("gelu_as.cuh", "sgemm.cuh", "sconv.cuh", "qkv_f32.cu",
                "mlp_f32.cu", "swiglu_f32.cu", "rcu_pair_f32.cu"):
        (tmp / src).write_text(emulated((CSRC_DIR / src).read_text()))
    paths = []
    for unit, (pre, inc, post) in units.items():
        path = tmp / (unit + ".cpp")
        path.write_text(UNIT % (pre, inc, post))
        paths.append(str(path))
    so = tmp / name
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         "-ffp-contract=off", "-w", f"-I{tmp}", f"-I{EMU_DIR}", *paths,
         "-o", str(so)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    emu = ctypes.CDLL(str(so))
    for entry in entries:
        getattr(emu, entry).argtypes = {**SIGNATURES, **EMU_SIGNATURES}[entry]
        getattr(emu, entry).restype = ctypes.c_int
    return emu


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("cuda_emu_f32"), UNITS,
                  ("vrvg_qkv_f32", "vrvg_ln_qkv_f32",
                   "vrvg_proj_ls_residual_f32", *EMU_SIGNATURES),
                  "libemu_f32.so")


@pytest.fixture(scope="module")
def mlp_lib(tmp_path_factory):
    """csrc/mlp_f32.cu as it is, with the host LayerNorm."""
    return _build(tmp_path_factory.mktemp("cuda_emu_mlp_f32"),
                  {"mlp_f32.cu": ("", "mlp_f32.cu", LN_HOST)},
                  ("vrvg_fc1_gelu_f32", "vrvg_mlp_residual_f32",
                   "vrvg_mlp_residual_hblocked_f32"), "libemu_mlp_f32.so")


def f32_ulps(got, want, *addends):
    """|got - want| in f32 ulps of the output's scale: the largest of |want|,
    the RMS of its last axis's feature over the rest, and each addend's
    magnitude (chip_smoke.py's f32 bound, on the CPU)."""
    w = want.double()
    size = torch.maximum(w.abs(), w.reshape(-1, w.shape[-1]).square()
                         .mean(dim=0).sqrt().expand_as(w.reshape(-1, w.shape[-1]))
                         .reshape(w.shape))
    for t in addends:
        size = torch.maximum(size, t.double().abs().expand_as(w))
    ulp = torch.exp2(torch.floor(torch.log2(size.clamp_min(2.0 ** -126))) - 23)
    return (got.double() - w).abs() / ulp


def randn(rng, shape, scale=1.0, shift=0.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale + shift).astype(np.float32))


@pytest.mark.parametrize("m,d", [(300, 128), (130, 192)])
def test_qkv_stage_source(lib, m, d):
    """Row 5's GEMM stage (QkvF32 on the core's 128 x 128 tiles): ragged last
    row tile, and at D = 192 a ragged last column tile (3D = 576)."""
    rng = np.random.default_rng(m + d)
    a = randn(rng, (1, m, d))
    w, b = randn(rng, (3 * d, d), d ** -0.5), randn(rng, (3 * d,), 0.5)
    heads, scale = d // 64, 64 ** -0.5
    out = torch.empty((1, m, 3, heads, 64))
    assert lib.vrvg_qkv_f32(a.data_ptr(), w.data_ptr(), b.data_ptr(),
                            out.data_ptr(), m, d, scale, None) == 0
    want = qkv_plain(a, w, b, heads, scale)
    bias = b.reshape(3, heads, 64).clone()
    bias[0] *= scale
    assert f32_ulps(out, want, bias).max() <= MAX_ULPS


def test_ln_qkv_chain_passes_on_the_layernorm_error(lib):
    """The chain returns its LayerNorm's error and runs no product."""
    m, d = 8, 128
    x = torch.zeros((m, d))
    out = torch.full((m, 3 * d), 5.0)
    err = lib.vrvg_ln_qkv_f32(x.data_ptr(), x.data_ptr(), x.data_ptr(),
                              x.data_ptr(), x.data_ptr(), x.data_ptr(),
                              out.data_ptr(), m, d, 1.0, 1e-6, None)
    assert err == 77 and bool((out == 5.0).all())


@pytest.mark.parametrize("m,d", [(300, 128), (77, 384)])
def test_proj_source(lib, m, d):
    """Row 6 (ProjF32: + bias, LayerScale, the residual) on the core."""
    rng = np.random.default_rng(7 * m + d)
    o = randn(rng, (1, m, d // 64, 64))
    x = randn(rng, (1, m, d))
    w, b = randn(rng, (d, d), d ** -0.5), randn(rng, (d,), 0.5)
    gamma = randn(rng, (d,), 0.1, 1.0)
    out = torch.empty_like(x)
    assert lib.vrvg_proj_ls_residual_f32(
        o.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
        gamma.data_ptr(), out.data_ptr(), m, d, None) == 0
    want = proj_ls_residual_plain(o, x, w, b, gamma)
    assert f32_ulps(out, want, x, gamma * b).max() <= MAX_ULPS


def test_mix_source(lib):
    """Row 7's out_conv mix at f32 (Tall64: 256 x 64 tiles, C = 64)."""
    rng = np.random.default_rng(5)
    x = randn(rng, (1, 13, 23, 64))
    koc = randn(rng, (64, 64, 1, 1), 0.125)
    xoc = torch.empty_like(x)
    km = koc[:, :, 0, 0].contiguous()
    assert lib.emu_mix_f32(x.data_ptr(), km.data_ptr(), xoc.data_ptr(),
                           13 * 23, 64) == 0
    assert f32_ulps(xoc, ext_mix_plain(x, koc)).max() <= MAX_ULPS


@pytest.mark.parametrize("hw", [(9, 17), (24, 40)])
def test_conv1_source(lib, hw):
    """Row 7's conv1 at f32, C = 64 -> C2 = 32: the im2col read in place
    with zero padding at every edge and the f32 bias in the store (Rows32,
    one 32-channel row a thread; 2 frames, a ragged last row tile)."""
    h, w = hw
    rng = np.random.default_rng(h * w)
    z = randn(rng, (2, h, w, 64))
    k1, b1 = randn(rng, (32, 64, 3, 3), 1 / 24), randn(rng, (32,), 0.5)
    c1 = torch.empty((2, h, w, 32))
    w1 = conv3x3_gemm_weights(k1, torch.float32)
    assert lib.emu_conv1_f32(z.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                             c1.data_ptr(), 2, h, w, 64, 32) == 0
    want = ext_conv1_plain(z, k1, b1)
    assert f32_ulps(c1, want, b1).max() <= MAX_ULPS


def test_conv2_depth_source(lib):
    """Row 7's (and row 12's) back at f32: conv2 (C2 = 32 -> 32), + b2,
    ReLU, the 1x1, + b3, ReLU, a pixel's 32 sums in one thread, against
    big_conv2_plain, relative to the depth's range."""
    rng = np.random.default_rng(11)
    h, w = 19, 33
    r = randn(rng, (2, h, w, 32))
    k2, b2 = randn(rng, (32, 32, 3, 3), 1 / 17), randn(rng, (32,), 0.3, 0.2)
    k3, b3 = randn(rng, (1, 32, 1, 1), 0.3), torch.tensor([0.4])
    out = torch.empty((2, h, w))
    w2 = conv3x3_gemm_weights(k2, torch.float32)
    w3 = k3.reshape(32).contiguous()
    assert lib.emu_conv2_depth_f32(r.data_ptr(), w2.data_ptr(),
                                   b2.data_ptr(), w3.data_ptr(),
                                   b3.data_ptr(), out.data_ptr(), 2, h, w,
                                   32) == 0
    want = big_conv2_plain(r, k2, b2, k3, b3)
    assert (want > 0).float().mean() > 0.2  # ReLU leaves live pixels
    span = (want.max() - want.min()).item()
    assert (out - want).abs().max().item() <= 1e-5 * span
    # Against F.conv2d directly, too: the conv's zero padding.
    y = F.relu(F.conv2d(r.permute(0, 3, 1, 2), k2, b2, padding=1))
    ref = F.relu((y * k3[0, :, 0, 0][:, None, None]).sum(dim=1) + b3)
    assert (out - ref).abs().max().item() <= 1e-5 * span


# --- rows 8 and 9 at f32 (csrc/mlp_f32.cu) ----------------------------------

def _mlp_args(rng, m, d):
    """Seeded f32 operands of the MLP half in PyTorch layout: x (1, M, D),
    the LN affine, fc1 (4D, D) + b1, fc2 (D, 4D) + b2, gamma."""
    hid = 4 * d
    return (randn(rng, (1, m, d)), randn(rng, (d,), 0.1, 1.0),
            randn(rng, (d,), 0.1), randn(rng, (hid, d), d ** -0.5),
            randn(rng, (hid,), 0.3), randn(rng, (d, hid), hid ** -0.5),
            randn(rng, (d,), 0.3), randn(rng, (d,), 0.1, 1.0))


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "tanh"])
def test_fc1_gelu_stage_source(mlp_lib, approx):
    """The fc1 stage (sgemm::BiasGelu on 128 x 128 tiles: a ragged last row
    tile, 4D = 512 columns): + b1, then the A&S or the tanh GELU on the
    f32 sum, against fc1_gelu_plain. The host's expf / tanhf stand in for
    the card's, so the bound is the core's, not bit for bit."""
    rng = np.random.default_rng(11 + approx)
    m, d = 130, 128
    a = randn(rng, (m, d))
    w1, b1 = randn(rng, (4 * d, d), d ** -0.5), randn(rng, (4 * d,), 0.5)
    h = torch.empty((m, 4 * d))
    assert mlp_lib.vrvg_fc1_gelu_f32(a.data_ptr(), w1.data_ptr(),
                                     b1.data_ptr(), h.data_ptr(), m, d,
                                     int(approx), None) == 0
    want = mlp.fc1_gelu_plain(a, w1, b1, approx)
    t = a @ w1.T + b1  # the GELU's input: its scale sets the GELU's ulps
    assert f32_ulps(h, want, t, b1).max() <= MAX_ULPS
    assert (want < 0).float().mean() > 0.2  # the GELU's negative arm ran


@pytest.mark.parametrize("entry,d,m", [
    ("vrvg_mlp_residual_f32", 128, 150), ("vrvg_mlp_residual_f32", 384, 70),
    ("vrvg_mlp_residual_hblocked_f32", 768, 33)])
def test_mlp_chain_source(mlp_lib, entry, d, m):
    """Rows 8 (D = 128, 384) and 9 (D = 768) at f32 as one chain: LN (on the
    host here), fc1 + b1 + GELU into the hidden scratch, fc2 + b2 +
    LayerScale + residual. The scratch holds the LN rows and the hidden
    activations; each stage is held against its plain version on the
    chain's own input (the host LN is not row 1's, and one ulp of a moves
    fc1's sums by more than their own ulps), and the whole against
    mlp_residual_plain relative to max |out|."""
    rng = np.random.default_rng(d + m)
    args = _mlp_args(rng, m, d)
    x, lnw, lnb, w1, b1, w2, b2, gamma = args
    a, h = torch.empty((m, d)), torch.empty((m, 4 * d))
    out = torch.empty_like(x)
    assert getattr(mlp_lib, entry)(
        x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
        a.data_ptr(), h.data_ptr(), out.data_ptr(), m, d, 1e-6, 0,
        None) == 0
    want_a = mlp.mlp_residual_stages(*args)[0]
    assert f32_ulps(a, want_a.reshape(m, d)).max() <= MAX_ULPS
    # Each product's scale includes the sum of its terms' magnitudes: at K =
    # 768 and 3072 the f32 sums' order moves a result by a few ulps of that.
    want_h = mlp.fc1_gelu_plain(a, w1, b1)
    assert f32_ulps(h, want_h, a @ w1.T + b1, b1,
                    a.abs() @ w1.abs().T).max() <= MAX_ULPS
    want = mlp.fc2_residual_plain(h, w2, b2, gamma, x.reshape(m, d))
    assert f32_ulps(out.reshape(m, d), want, x.reshape(m, d), gamma * b2,
                    gamma.abs() * (h.abs() @ w2.abs().T)).max() <= MAX_ULPS
    whole = mlp.mlp_residual_plain(*args)
    assert (out - whole).abs().max() <= 1e-5 * whole.abs().max()


def test_mlp_entry_points_refuse_other_widths(mlp_lib):
    """Row 8's f32 entry point takes D = 128 and 384 only, row 9's a
    multiple of 128: others return cudaErrorInvalidValue (1) and write
    nothing."""
    for entry, d in (("vrvg_mlp_residual_f32", 768),
                     ("vrvg_mlp_residual_f32", 256),
                     ("vrvg_mlp_residual_hblocked_f32", 200)):
        m = 4
        x = torch.zeros((m, d))
        out = torch.full((m, d), 5.0)
        err = getattr(mlp_lib, entry)(
            *(x.data_ptr(),) * 8, x.data_ptr(), x.data_ptr(), out.data_ptr(),
            m, d, 1e-6, 0, None)
        assert err == 1 and bool((out == 5.0).all())


# --- rows 7, 11 and 12 at f32 at every width (csrc/sconv.cuh) ---------------

@pytest.mark.parametrize("c", [128, 384])
def test_mix_by_width_source(lib, c):
    """Row 7's out_conv mix at f32 on the tile gemm_n picks for N = C above
    64 (Square, 128 x 128: at C = 384 three column tiles)."""
    rng = np.random.default_rng(c)
    x = randn(rng, (1, 9, 15, c))
    koc = randn(rng, (c, c, 1, 1), c ** -0.5)
    xoc = torch.empty_like(x)
    km = koc[:, :, 0, 0].contiguous()
    assert lib.emu_mix_n_f32(x.data_ptr(), km.data_ptr(), xoc.data_ptr(),
                             9 * 15, c) == 0
    assert f32_ulps(xoc, ext_mix_plain(x, koc)).max() <= MAX_ULPS


@pytest.mark.parametrize("c", [128, 384])
def test_ext_conv1_by_width_source(lib, c):
    """Row 7's conv1 at f32 with its bias at C2 = 64 (Tall64) and 192
    (Square, a half-empty second column tile), 2 frames, zero padding at
    every edge."""
    rng = np.random.default_rng(3 * c)
    h, w, c2 = 7, 13, c // 2
    z = randn(rng, (2, h, w, c))
    k1, b1 = randn(rng, (c2, c, 3, 3), (9 * c) ** -0.5), randn(rng, (c2,), 0.5)
    c1 = torch.empty((2, h, w, c2))
    w1 = conv3x3_gemm_weights(k1, torch.float32)
    assert lib.emu_conv3x3_f32(z.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                               c1.data_ptr(), 2, h, w, c, c2) == 0
    assert f32_ulps(c1, ext_conv1_plain(z, k1, b1), b1).max() <= MAX_ULPS


@pytest.mark.parametrize("c", [64, 128, 256])
def test_big_tail_chain_source(lib, c):
    """Rows 11 and 12 at f32 as vrvg_head_tail_big_f32 runs them, the passes
    their plain versions: the folded conv1, bias-free (Store; C2 = 32, 64,
    128 on Rows32, Tall64, Square), then the resize pass with cw, then
    conv2 with the 1x1 (Rows32); mid in f32 ulps against big_conv1_plain,
    the depth against head_tail_big_plain relative to its range. A 4-row
    grid: most conv1 rows are cw's top or bottom rows."""
    rng = np.random.default_rng(c + 5)
    b, h0, w0, c2 = 2, 4, 7, c // 2
    out_hw = (14, 24)
    x = randn(rng, (b, h0, w0, c))
    wts = [randn(rng, (c, c, 1, 1), c ** -0.5), randn(rng, (c,), 0.1),
           randn(rng, (c2, c, 3, 3), (9 * c) ** -0.5), randn(rng, (c2,), 0.1),
           randn(rng, (32, c2, 3, 3), (9 * c2) ** -0.5), randn(rng, (32,), 0.1),
           randn(rng, (1, 32, 1, 1), 32 ** -0.5), randn(rng, (1,), 0.1, 0.5)]
    k_oc, b_oc, k1, b1, k2, b2, k3, b3 = wts
    u = ht.big_upsample_plain(x)
    w1m = conv3x3_gemm_weights(ht.fold_conv1(k_oc, k1, torch.float32),
                               torch.float32)
    mid = torch.empty((b, 2 * h0, 2 * w0, c2))
    assert lib.emu_conv3x3_f32(u.data_ptr(), w1m.data_ptr(), None,
                               mid.data_ptr(), b, 2 * h0, 2 * w0, c, c2) == 0
    assert f32_ulps(mid, ht.big_conv1_plain(u, k_oc, k1)).max() <= MAX_ULPS
    r = ht.big_resize_plain(mid, k1, b_oc, b1, out_hw).contiguous()
    out = torch.empty((b, *out_hw))
    w2 = conv3x3_gemm_weights(k2, torch.float32)
    assert lib.emu_conv2_depth_n_f32(
        r.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        k3.reshape(32).contiguous().data_ptr(), b3.data_ptr(),
        out.data_ptr(), b, *out_hw, c2) == 0
    want = ht.head_tail_big_plain(x, *wts, out_hw)
    span = (want.max() - want.min()).item()
    assert span > 0 and (want > 0).float().mean() > 0.2
    assert (out - want).abs().max().item() <= 1e-5 * span


# --- row 10 at f32 (csrc/swiglu_f32.cu) --------------------------------------

@pytest.fixture(scope="module")
def swiglu_lib(tmp_path_factory):
    """csrc/swiglu_f32.cu as it is, with the host LayerNorm."""
    return _build(tmp_path_factory.mktemp("cuda_emu_swiglu_f32"),
                  {"swiglu_f32.cu": ("", "swiglu_f32.cu", LN_HOST)},
                  ("vrvg_swiglu_gate_f32", "vrvg_swiglu_residual_f32"),
                  "libemu_swiglu_f32.so")


def _swiglu_args(rng, m, d, hid):
    """Seeded f32 operands of the SwiGLU half in PyTorch layout: x (1, M,
    D), the LN affine, w12 (2H, D) + b12, w3 (D, H) + b3, gamma."""
    return (randn(rng, (1, m, d)), randn(rng, (d,), 0.1, 1.0),
            randn(rng, (d,), 0.1), randn(rng, (2 * hid, d), d ** -0.5),
            randn(rng, (2 * hid,), 0.3), randn(rng, (d, hid), hid ** -0.5),
            randn(rng, (d,), 0.3), randn(rng, (d,), 0.1, 1.0))


def _gate(lib, h, w12, b12):
    m, d = h.shape
    hid = w12.shape[0] // 2
    g = torch.full((m, hid), float("nan"))
    assert lib.vrvg_swiglu_gate_f32(h.data_ptr(), w12.data_ptr(),
                                    b12.data_ptr(), g.data_ptr(), m, d, hid,
                                    None) == 0
    return g


def _gate_bound(h, w12, b12):
    """The gate's addends for f32_ulps: an ulp of x1's sum (its terms'
    magnitudes) moves g by about |x2| of them, an ulp of x2's by |x1|."""
    hid = w12.shape[0] // 2
    t, mag = h @ w12.T + b12, h.abs() @ w12.abs().T + b12.abs()
    return (t[:, :hid].abs() * t[:, hid:].abs(),
            mag[:, :hid] * t[:, hid:].abs(), mag[:, hid:] * t[:, :hid].abs())


@pytest.mark.parametrize("hid", [128, 200, 344])
def test_gated_operand_pairs_x1_and_x2(swiglu_lib, hid):
    """sgemm::GatedRows and SwigluGate on a selection: h the identity (row i
    picks input column i), so every sum is one exact product and g[i, c] =
    silu(w12[c, i] + b12[c]) * (w12[H + c, i] + b12[H + c]) on distinct
    seeded values; only the host's expf against torch's exp may differ (a
    few ulps), where a wrong pairing of x1 and x2 columns would be off
    entirely. H a multiple of 64 (128) and not (200, 344: a last tile of 8
    and 24 g columns)."""
    d = 64
    rng = np.random.default_rng(hid)
    h = torch.eye(d)
    w12, b12 = randn(rng, (2 * hid, d), 2.0), randn(rng, (2 * hid,))
    got = _gate(swiglu_lib, h, w12, b12)
    want = mlp.swiglu_gate_plain(h, w12, b12)
    assert torch.isfinite(got).all()
    assert f32_ulps(got, want).max() <= 4
    assert (got != 0).float().mean() > 0.99


@pytest.mark.parametrize("m,d,hid", [(130, 128, 344), (33, 64, 200),
                                     (70, 256, 688)])
def test_swiglu_gate_stage_source(swiglu_lib, m, d, hid):
    """The gate stage (128 x 128 tiles of 64 x1 and 64 x2 columns: a ragged
    last row tile, and H = 344, 200 and 688 not multiples of 64): + b12,
    then silu(x1) * x2 on the f32 sums, against swiglu_gate_plain. The
    host's expf stands in for the card's, so the bound is the core's."""
    rng = np.random.default_rng(m + d + hid)
    h = randn(rng, (m, d))
    w12, b12 = randn(rng, (2 * hid, d), d ** -0.5), randn(rng, (2 * hid,), 0.5)
    got = _gate(swiglu_lib, h, w12, b12)
    want = mlp.swiglu_gate_plain(h, w12, b12)
    assert f32_ulps(got, want, *_gate_bound(h, w12, b12)).max() <= MAX_ULPS
    assert (want < 0).float().mean() > 0.2  # silu's negative arm and x2 < 0


@pytest.mark.parametrize("d,m", [(128, 150), (256, 70)])
def test_swiglu_chain_source(swiglu_lib, d, m):
    """Row 10 at f32 as one chain (LN on the host here, the gate into the g
    scratch, the down product + b3 + LayerScale + residual), hidden from
    swiglu_hidden (344, 688: not multiples of 64): each stage against its
    plain version on the chain's own input, and the whole against
    swiglu_residual_plain relative to max |out|."""
    hid = mlp.swiglu_hidden(d)
    rng = np.random.default_rng(d + m + 1)
    args = _swiglu_args(rng, m, d, hid)
    x, lnw, lnb, w12, b12, w3, b3, gamma = args
    h, g = torch.empty((m, d)), torch.empty((m, hid))
    out = torch.empty_like(x)
    assert swiglu_lib.vrvg_swiglu_residual_f32(
        x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), w12.data_ptr(),
        b12.data_ptr(), w3.data_ptr(), b3.data_ptr(), gamma.data_ptr(),
        h.data_ptr(), g.data_ptr(), out.data_ptr(), m, d, hid, 1e-6,
        None) == 0
    want_h = mlp.swiglu_residual_stages(*args)[0]
    assert f32_ulps(h, want_h).max() <= MAX_ULPS
    want_g = mlp.swiglu_gate_plain(h, w12, b12)
    assert f32_ulps(g, want_g, *_gate_bound(h, w12, b12)).max() <= MAX_ULPS
    x2 = x.reshape(m, d)
    want = mlp.fc2_residual_plain(g, w3, b3, gamma, x2)
    assert f32_ulps(out.reshape(m, d), want, x2, gamma * b3,
                    gamma.abs() * (g.abs() @ w3.abs().T)).max() <= MAX_ULPS
    whole = mlp.swiglu_residual_plain(*args)
    assert (out - whole).abs().max() <= 1e-5 * whole.abs().max()


def test_swiglu_entry_points_refuse_other_widths(swiglu_lib):
    """D or H not a multiple of 4: cudaErrorInvalidValue (1), nothing
    written."""
    for d, hid in ((66, 128), (64, 130)):
        m = 4
        x = torch.zeros((m, 2 * max(d, hid) * 2))
        out = torch.full((m, d), 5.0)
        err = swiglu_lib.vrvg_swiglu_residual_f32(
            *(x.data_ptr(),) * 10, out.data_ptr(), m, d, hid, 1e-6, None)
        assert err == 1 and bool((out == 5.0).all())
        g = torch.full((m, hid), 5.0)
        assert swiglu_lib.vrvg_swiglu_gate_f32(
            x.data_ptr(), x.data_ptr(), x.data_ptr(), g.data_ptr(), m, d, hid,
            None) == 1
        assert bool((g == 5.0).all())


# --- row 15 at f32 (vrvg_head_tail_f32's products) ---------------------------

@pytest.mark.parametrize("c", [64, 128])
def test_base_tail_chain_source(lib, c):
    """Row 15 at f32 as vrvg_head_tail_f32 runs it, the resize pass its plain
    version: conv1 of path1 with its f32 bias (BiasStore on Rows32 at C2 =
    32, Tall64 at 64), then the resize pass, then conv2 with the 1x1
    (Rows32); c1 in f32 ulps against base_conv1_plain, the depth against
    head_tail_plain relative to its range. 2 frames, zero padding at every
    edge."""
    rng = np.random.default_rng(c + 15)
    b, h2, w2, c2 = 2, 8, 14, c // 2
    out_hw = (15, 26)
    x = randn(rng, (b, h2, w2, c))
    k1, b1 = randn(rng, (c2, c, 3, 3), (9 * c) ** -0.5), randn(rng, (c2,), 0.1)
    k2, b2 = randn(rng, (32, c2, 3, 3), (9 * c2) ** -0.5), randn(rng, (32,),
                                                                  0.1)
    k3, b3 = randn(rng, (1, 32, 1, 1), 32 ** -0.5), randn(rng, (1,), 0.1, 0.5)
    c1 = torch.empty((b, h2, w2, c2))
    w1m = conv3x3_gemm_weights(k1, torch.float32)
    assert lib.emu_conv3x3_f32(x.data_ptr(), w1m.data_ptr(), b1.data_ptr(),
                               c1.data_ptr(), b, h2, w2, c, c2) == 0
    assert f32_ulps(c1, ht.base_conv1_plain(x, k1, b1), b1).max() <= MAX_ULPS
    r = ht.ext_resize_plain(c1, out_hw).contiguous()
    out = torch.empty((b, *out_hw))
    w2m = conv3x3_gemm_weights(k2, torch.float32)
    assert lib.emu_conv2_depth_n_f32(
        r.data_ptr(), w2m.data_ptr(), b2.data_ptr(),
        k3.reshape(32).contiguous().data_ptr(), b3.data_ptr(),
        out.data_ptr(), b, *out_hw, c2) == 0
    want = ht.head_tail_plain(x, k1, b1, k2, b2, k3, b3, out_hw)
    span = (want.max() - want.min()).item()
    assert span > 0 and (want > 0).float().mean() > 0.2
    assert (out - want).abs().max().item() <= 1e-5 * span


# --- row 16 at f32 (csrc/rcu_pair_f32.cu) ------------------------------------

@pytest.fixture(scope="module")
def rcu_lib(tmp_path_factory):
    """csrc/rcu_pair_f32.cu as it is."""
    return _build(tmp_path_factory.mktemp("cuda_emu_rcu_f32"),
                  {"rcu_pair_f32.cu": ("", "rcu_pair_f32.cu", "")},
                  ("vrvg_rcu_conv_f32",), "libemu_rcu_f32.so")


def _emu_rcu_conv(lib, x, k, b, relu, residuals=(), relu_done=False,
                  relu_copy=False):
    """rcu_conv's call of vrvg_rcu_conv_f32, on the emulated library."""
    n, h, w, c = x.shape
    wt = conv3x3_gemm_weights(k, torch.float32)
    out = torch.full_like(x, float("nan"))
    in_relu = torch.empty_like(x) if relu and not relu_done else None
    out_relu = torch.full_like(x, float("nan")) if relu_copy else None
    ptrs = [r.data_ptr() for r in residuals] + [None] * (2 - len(residuals))
    err = lib.vrvg_rcu_conv_f32(
        x.data_ptr(), None if in_relu is None else in_relu.data_ptr(),
        wt.data_ptr(), b.data_ptr(), *ptrs, out.data_ptr(),
        None if out_relu is None else out_relu.data_ptr(), n, h, w, c,
        int(relu), len(residuals), None)
    assert err == 0
    if in_relu is not None:
        assert torch.equal(in_relu, F.relu(x))
    return (out, out_relu) if relu_copy else out


@pytest.mark.parametrize("c", [64, 128])
def test_rcu_chain_source(rcu_lib, c):
    """Row 16 at f32: the four convs of rcu_chain, each on the plain chain's
    own input and residuals (conv1a after the ReLU pass; conv2a with two
    residuals and its ReLU'd copy; conv1b reading that copy; conv2b with
    one residual), at C = 64 (Tall64) and 128 (Square), 2 frames, a ragged
    last row tile: each in f32 ulps of its output's scale and sums against
    rcu_conv_plain, the copy bit for bit the ReLU of the output, and the
    emulated chain against refinenet_pre_plain relative to max |out|."""
    from vr_video_generator_tpu_torch.attic.refinenet_pre import (
        rcu_chain, rcu_conv_plain, refinenet_pre_plain)

    rng = np.random.default_rng(c + 16)
    shape = (2, 7, 11, c)
    rn0, path2 = randn(rng, shape), randn(rng, shape)
    ws = []
    for _ in range(4):
        ws += [randn(rng, (c, c, 3, 3), (9 * c) ** -0.5), randn(rng, (c,), 0.1)]
    steps = []

    def record(*args, **kw):
        steps.append((args, kw))
        return rcu_conv_plain(*args, **kw)

    rcu_chain(record, rn0, path2, *ws)
    assert len(steps) == 4
    for args, kw in steps:
        got = _emu_rcu_conv(rcu_lib, *args, **kw)
        want = rcu_conv_plain(*args, **kw)
        if kw.get("relu_copy"):
            assert torch.equal(got[1], F.relu(got[0]))
            got, want = got[0], want[0]
        x, k = args[0], args[1]
        mag = F.conv2d(F.relu(x).permute(0, 3, 1, 2).abs(), k.abs(),
                       padding=1).permute(0, 2, 3, 1)
        res = args[4] if len(args) > 4 else ()
        assert f32_ulps(got, want, mag, *res).max() <= MAX_ULPS
    got = rcu_chain(lambda *a, **kw: _emu_rcu_conv(rcu_lib, *a, **kw), rn0,
                    path2, *ws)
    want = refinenet_pre_plain(rn0, path2, *ws)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_rcu_entry_point_refuses_other_kinds(rcu_lib):
    """C outside {64, 128}, an input ReLU pass on a conv without ReLU, a
    ReLU with residuals or with a copy, no residual without ReLU: 1
    (cudaErrorInvalidValue), nothing written."""
    x = torch.zeros((1, 4, 4, 128))
    out = torch.full_like(x, 5.0)
    p = x.data_ptr()
    for c, in_relu, relu, nres, out_relu in (
            (96, None, 1, 0, None), (64, p, 0, 1, None), (64, None, 1, 1, None),
            (64, None, 1, 0, p), (128, None, 0, 0, None), (128, None, 0, 3,
                                                           None)):
        err = rcu_lib.vrvg_rcu_conv_f32(p, in_relu, p, p, p, p,
                                        out.data_ptr(), out_relu, 1, 4, 4, c,
                                        relu, nres, None)
        assert err == 1 and bool((out == 5.0).all())
