"""PyTorch port, f32 on the card: the f32 kernels' CUDA sources run on the
CPU under the host emulation of CUDA (tests/cuda_emu/cuda_runtime.h),
against their plain versions.

g++ compiles csrc/qkv_f32.cu (the f32 GEMM core of csrc/sgemm.cuh with row
5's and row 6's epilogues) and csrc/rcu_pair_f32.cu (row 16 at f32: the
ReLU pass and each conv of the chain with its bias, ReLU, residuals and
ReLU'd copy) as they are,
launches rewritten to the emulator's, and a unit that instantiates the core
with the f32 DPT tails' operands (csrc/sconv.cuh: the 3x3 conv as an
implicit GEMM, conv1's bias and bias-free stores, conv2's depth epilogue,
and the tile each product takes by width) as vrvg_head_tail_ext_f32 and
vrvg_head_tail_f32 (row 15 at f32) call them; the tails' passes (upsample,
resize) are their plain versions around them. Each CUDA thread is a std::thread and each
__syncthreads a barrier, so the tiles' indexing, the ragged edges and the
double-buffered k slices run as written. Rows 2 and 17 at f32
(csrc/attention_f32.cu), rows 8, 9 and 10 at f32 (csrc/mlp_f32.cu and
csrc/swiglu_f32.cu on the 3xTF32 core of csrc/tf32x3_gemm.cuh: TMA and
wgmma, which the emulation has not) and rows 11 and 12 at f32 (the same
core's conv layout in csrc/head_tail_big.cu) are held on the CPU by
tests/test_torch_attention_3xtf32.py, tests/test_torch_gemm_3xtf32.py and
tests/test_torch_conv_3xtf32.py.
The plain versions sum in another order, so each output is held to a bound
in f32 ulps of its scale (the f32 sums' reordering: a few ulps; a TF32
product would be thousands off). This checks logic only; the card checks
the kernels themselves (chip_smoke.py phase 8). Needs g++ (C++20).
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
    for src in ("gelu_as.cuh", "epilogue_f32.cuh", "sgemm.cuh", "sconv.cuh",
                "qkv_f32.cu", "rcu_pair_f32.cu"):
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
    """The SIMT f32 core's convs (csrc/sconv.cuh) on the big-C tail's
    chain, the passes their plain versions: a bias-free conv3x3 (Store; C2 =
    32, 64, 128 on Rows32, Tall64, Square: the tiles row 7 at f32 runs its
    conv1 on at C = 64-256, conv1 at C = 256 on Square), then the resize
    pass with cw, then conv2 with the 1x1 (Rows32, row 7's and row 15's
    back); mid in f32 ulps against big_conv1_plain, the depth against
    head_tail_big_plain relative to its range. A 4-row grid: most conv1
    rows are cw's top or bottom rows. (Rows 11 and 12 at f32 run their
    convs on the 3xTF32 core, tests/test_torch_conv_3xtf32.py.)"""
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
