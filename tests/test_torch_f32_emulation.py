"""PyTorch port, f32 on the card: the f32 kernels' CUDA sources run on the
CPU under the host emulation of CUDA (tests/cuda_emu/cuda_runtime.h),
against their plain versions.

g++ compiles csrc/qkv_f32.cu (the f32 GEMM core of csrc/sgemm.cuh with row
5's and row 6's epilogues) and csrc/attention_f32.cu (rows 2 and 17 at f32)
as they are, launches rewritten to the emulator's, and a unit that
instantiates the core with the f32 DPT tail's operands (csrc/sconv.cuh: the
3x3 conv as an implicit GEMM, conv1's bias store, conv2's depth epilogue)
as vrvg_head_tail_ext_f32 does. Each CUDA thread is a std::thread and each
__syncthreads a barrier, so the tiles' indexing, the ragged edges, the
double-buffered k slices and the online softmax run as written. The plain
versions sum in another order, so each output is held to a bound in f32
ulps of its scale (the f32 sums' reordering: a few ulps; a TF32 product
would be thousands off). This checks logic only; the card checks the
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
from vr_video_generator_tpu_torch.ops.attention import (attention_plain,
                                                        flash_attention_plain)
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
"""
UNITS = {"qkv_f32.cu": ("", "qkv_f32.cu", LN_STUB),
         "attention_f32.cu": ("", "attention_f32.cu", ""),
         "tail_f32.cpp": ("", "sconv.cuh", TAIL_ENTRIES)}
_P, _I = ctypes.c_void_p, ctypes.c_int
EMU_SIGNATURES = {
    "emu_mix_f32": [_P, _P, _P, _I, _I],
    "emu_conv1_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I],
    "emu_conv2_depth_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I],
}
# Bounds in f32 ulps of each output's scale (the largest of the output, its
# feature's RMS and its addends): f32 sums in another order than the plain
# version's.
MAX_ULPS = 64


def emulated(text: str) -> str:
    """kernel<<<grid, block, smem, stream>>>(...) -> the emulator's launch."""
    return re.sub(r"(\w+(?:<[\w\s,]+>)?)\s*<<<(.*?)>>>\(",
                  r"emu::Launch(\2)(\1, ", text, flags=re.S)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build the CUDA emulation")
    tmp = tmp_path_factory.mktemp("cuda_emu_f32")
    for name in ("sgemm.cuh", "sconv.cuh", "qkv_f32.cu", "attention_f32.cu"):
        (tmp / name).write_text(emulated((CSRC_DIR / name).read_text()))
    units = []
    for unit, (pre, inc, post) in UNITS.items():
        path = tmp / (unit + ".cpp")
        path.write_text(UNIT % (pre, inc, post))
        units.append(str(path))
    so = tmp / "libemu_f32.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         "-ffp-contract=off", "-w", f"-I{tmp}", f"-I{EMU_DIR}", *units,
         "-o", str(so)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    emu = ctypes.CDLL(str(so))
    for name in ("vrvg_qkv_f32", "vrvg_ln_qkv_f32",
                 "vrvg_proj_ls_residual_f32", "vrvg_attention_f32",
                 "vrvg_flash_attention_f32"):
        getattr(emu, name).argtypes = SIGNATURES[name]
        getattr(emu, name).restype = ctypes.c_int
    for name, argtypes in EMU_SIGNATURES.items():
        getattr(emu, name).argtypes = argtypes
        getattr(emu, name).restype = ctypes.c_int
    return emu


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


def _attention(lib, entry, q, k, v, scale):
    b, n, h, _ = q.shape
    o = torch.empty((b, n, h, 64))
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, h,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), o.stride(0), o.stride(1), scale, None)
    assert err == 0
    return o


@pytest.mark.parametrize("n", [45, 160])
@pytest.mark.parametrize("flash", [False, True], ids=["row2", "row17"])
def test_attention_source(lib, n, flash):
    """Rows 2 and 17 at f32 with k and v strided views into one qkv: a
    ragged last key tile (45: one tile, 160: five), query rows past N in
    the block, peaked logits; against the one-shot and the blocked flash
    plain versions, relative to max |o| (f32 rounding only, nothing cast)."""
    rng = np.random.default_rng(n + 3 * flash)
    b, h, scale = 2, 2, 64 ** -0.5
    qkv = randn(rng, (b, n, 3, h, 64), 2.0)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if flash:
        got = _attention(lib, "vrvg_flash_attention_f32", q, k, v, scale)
        want = flash_attention_plain(q, k, v, scale)
    else:
        qs = (q * scale).contiguous()
        got = _attention(lib, "vrvg_attention_f32", qs, k, v, 1.0)
        want = attention_plain(qs, k, v)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item()


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
