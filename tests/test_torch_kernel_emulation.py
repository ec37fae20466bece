"""PyTorch port: the compositors (rows 3 and 14) and blur/select (rows 4 and
13) CUDA sources run on the CPU under a host emulation of CUDA
(tests/cuda_emu/cuda_runtime.h), against their plain versions, bit for bit;
and rows 2 and 17 at any head dim but 64 (csrc/attention_any.cu) against
theirs, within bounds.

g++ compiles csrc/warp.cu, csrc/blur_select.cu and csrc/attention_any.cu as
they are, with their
launches rewritten to the emulator's and the three cp.async instructions of
csrc/rowcopy.cuh replaced by copies that poison their destination until a
wait retires them (and its L2 prefetch by nothing). Each CUDA thread is a std::thread and each
__syncthreads a barrier, so the kernels' indexing, rings, alignment
handling and the order of their barriers and copies run as written, on
frames of odd widths and tables made to break shortcuts. This checks logic
only; the card checks the kernels themselves (tests/test_torch_cuda.py,
chip_smoke.py). Needs g++ (C++20).
"""

import ctypes
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_banded_scatter import CASES as BANDED_CASES
from tests.test_torch_banded_scatter import case_inputs
from tests.test_torch_warp_scatter import jax_inputs
from tests.warp_tables import (above_all, all_invalid, descending,
                               overlapping, random_bands, unbounded)
from vr_video_generator_tpu_torch.attention_bench import (error_stats,
                                                          peaked_qkv)
from vr_video_generator_tpu_torch.kernels.build import CSRC_DIR, SIGNATURES
from vr_video_generator_tpu_torch.ops import attention as attn_ops
from vr_video_generator_tpu_torch.ops.attention import (attention_plain,
                                                        flash_attention_plain)
from vr_video_generator_tpu_torch.ops.warp import (
    WarpSpec, _taps, blur_select_sbs_packed_plain, blur_select_sbs_plain,
    warp_composite_banded_plain, warp_composite_plain)
from vr_video_generator_tpu_torch.utils.config import StereoConfig

torch.set_num_threads(2)

EMU_DIR = Path(__file__).resolve().parent / "cuda_emu"
ASYNC = """__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  emu::cp_async16(dst, src);
}
__device__ __forceinline__ void cp_async_commit() { emu::cp_async_commit(); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { emu::cp_async_wait(N); }
__device__ __forceinline__ void prefetch_l2(const void*) {}

"""
UNIT = """#include <cuda_runtime.h>
namespace {
alignas(1024) unsigned char smem[emu::SHARED_BYTES];
}
namespace emu {
static unsigned char* shared_memory() { return smem; }
}
#include "%s"
"""
SOURCES = ("warp.cu", "blur_select.cu", "attention_any.cu")


def emulated(text: str) -> str:
    """kernel<<<grid, block, smem, stream>>>(...) -> the emulator's launch."""
    return re.sub(r"(\w+(?:<[\w\s,]+>)?)\s*<<<(.*?)>>>\(",
                  r"emu::Launch(\2)(\1, ", text, flags=re.S)


def build(tmp, units, names):
    """g++ the emulation units into one library under tmp, with the entry
    points ``names`` bound by their signatures."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build the CUDA emulation")
    so = tmp / "libemu.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         "-ffp-contract=off", "-w", f"-I{tmp}", f"-I{EMU_DIR}", *units,
         "-o", str(so)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    emu = ctypes.CDLL(str(so))
    for name in names:
        getattr(emu, name).argtypes = SIGNATURES[name]
        getattr(emu, name).restype = ctypes.c_int
    return emu


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cuda_emu")
    rowcopy = (CSRC_DIR / "rowcopy.cuh").read_text()
    start = rowcopy.index("__device__ __forceinline__ void cp_async16(")
    end = rowcopy.index("// Bytes of a shared-memory slot")
    (tmp / "rowcopy.cuh").write_text(rowcopy[:start] + ASYNC + rowcopy[end:])
    units = []
    for name in SOURCES:
        (tmp / name).write_text(emulated((CSRC_DIR / name).read_text()))
        unit = tmp / (name + ".cpp")
        unit.write_text(UNIT % name)
        units.append(str(unit))
    return build(tmp, units, ("vrvg_warp_composite",
                              "vrvg_warp_composite_banded",
                              "vrvg_blur_select_sbs", "vrvg_attention_any"))


# Row 17's softmax blocks cut from 512 keys past 4096 to 128 keys past 256,
# in the source and in the plain version alike, so that a few hundred keys
# walk several blocks on the emulator (4200 keys take minutes there).
SMALL_BLOCKS = {"FLASH_ONE_BLOCK": 256, "FLASH_BLOCK": 128}


@pytest.fixture(scope="module")
def small_blocks(tmp_path_factory):
    """csrc/attention_any.cu with SMALL_BLOCKS' constants, built alone."""
    tmp = tmp_path_factory.mktemp("cuda_emu_blocks")
    src = emulated((CSRC_DIR / "attention_any.cu").read_text())
    for name, value in SMALL_BLOCKS.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        assert n == 1, name
    (tmp / "attention_any.cu").write_text(src)
    unit = tmp / "attention_any.cu.cpp"
    unit.write_text(UNIT % "attention_any.cu")
    return build(tmp, [str(unit)], ("vrvg_attention_any",))


def composite(lib, imgs, depth, st, s_neg, s_pos, banded=False):
    b, h, w, _ = imgs.shape
    out = torch.empty_like(imgs)
    cov = torch.empty((b, h, w), dtype=torch.bool)
    lo, hi = st.lo.contiguous(), st.hi.contiguous()
    valid = st.valid.contiguous()
    fill = st.fill_offset.to(torch.int32).contiguous()
    entry = (lib.vrvg_warp_composite_banded if banded
             else lib.vrvg_warp_composite)
    err = entry(
        imgs.data_ptr(), depth.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        valid.data_ptr(), fill.data_ptr(), out.data_ptr(), cov.data_ptr(),
        b, h, w, s_neg, s_neg + s_pos + 1, None)
    assert err == 0
    return out, cov


def blur_select(lib, comp, cov, imgs, edge, ksize, sigma, packed):
    b, h, w, _ = imgs.shape
    kx, ky = 2 * ksize + 3, 2 * ksize + 1
    kxw, kyw = _taps(kx, sigma), _taps(ky, sigma)
    edge = edge.to(torch.int32).contiguous()
    out = (torch.empty((b, h, 2 * w), dtype=torch.int32) if packed else
           torch.empty((b, h, 2 * w, 3), dtype=torch.uint8))
    err = lib.vrvg_blur_select_sbs(
        comp.data_ptr(), cov.data_ptr(), imgs.data_ptr(), edge.data_ptr(),
        kxw.data_ptr(), kyw.data_ptr(), out.data_ptr(), b, h, w, kx, ky,
        int(packed), None)
    assert err == 0
    return out


WARP_CASES = {
    "jax-61x97": ((61, 97), None),
    "jax-150x96": ((150, 96), None),
    "three-overlapping-bands": ((61, 97), overlapping),
    "bands-descending": ((61, 97), descending),
    "random-bands": ((61, 97), random_bands),
    "depth-above-every-band": ((61, 97), above_all),
    "all-shifts-invalid": ((61, 97), all_invalid),
    "unbounded-bands-nan-depth": ((61, 97), unbounded),
}


@pytest.mark.parametrize("case", list(WARP_CASES))
def test_compositor_source_bit_exact(lib, case):
    (h, w), make = WARP_CASES[case]
    spec, imgs, depth, st = jax_inputs(h, w)
    if make is not None:
        imgs, depth, st = make(spec, imgs, depth, st)
    got, got_cov = composite(lib, imgs, depth.contiguous(), st, spec.s_neg,
                             spec.s_pos)
    want, want_cov = warp_composite_plain(imgs, depth, st, spec.s_neg,
                                          spec.s_pos)
    assert torch.equal(got_cov, want_cov)
    assert torch.equal(got, want)


def test_compositor_source_shifts_wider_than_the_frame(lib, monkeypatch):
    """120 x 16 with 1080 rows' tables (s_pos = 48 >= 3 w), and many blocks
    of one or two rows each."""
    monkeypatch.setenv("EMU_SMS", "40")
    spec = WarpSpec.create(1080, 16, StereoConfig())
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 120, 16, 3),
                                         dtype=np.uint8))
    ramp = np.linspace(0, 1, 16, dtype=np.float32)[None, None, :]
    depth = torch.from_numpy(np.clip(
        ramp * np.array([14.0, 30.0], np.float32)[:, None, None]
        + rng.normal(0, 0.5, (2, 120, 16)).astype(np.float32), 0, None))
    ls = torch.ceil(depth.amax(dim=(1, 2)))
    ranges = torch.stack([spec.cfg.offset_bg * 1080 * ls / 14.0,
                          spec.cfg.offset_fg * 1080 * ls / 14.0], dim=1)
    _, st = spec.tables(depth, ranges)
    got, got_cov = composite(lib, imgs, depth, st, spec.s_neg, spec.s_pos)
    want, want_cov = warp_composite_plain(imgs, depth, st, spec.s_neg,
                                          spec.s_pos)
    assert torch.equal(got_cov, want_cov) and torch.equal(got, want)


@pytest.mark.parametrize("case", list(BANDED_CASES))
def test_banded_compositor_source_bit_exact(lib, case):
    """Row 14 on every table of the banded compositor's CPU tests
    (tests/test_torch_banded_scatter.py), the 126-shift table and shifts
    wider than the frame among them, against the TPU kernel's formulation
    (warp_composite_banded_plain)."""
    imgs, depth, st, s_neg, s_pos = case_inputs(case)
    got, got_cov = composite(lib, imgs, depth.contiguous(), st, s_neg, s_pos,
                             banded=True)
    want, want_cov = warp_composite_banded_plain(imgs, depth, st, s_neg,
                                                 s_pos)
    assert torch.equal(got_cov, want_cov)
    assert torch.equal(got, want)


def test_banded_compositor_source_refuses_127_shifts(lib):
    """The entry point takes at most 126 shifts (the code's 7-bit rank)."""
    spec, imgs, depth, st = jax_inputs(61, 97)
    b, h, w, _ = imgs.shape
    lo = torch.zeros((b, 127))
    err = lib.vrvg_warp_composite_banded(
        imgs.data_ptr(), depth.data_ptr(), lo.data_ptr(), lo.data_ptr(),
        torch.zeros((b, 127), dtype=torch.bool).data_ptr(),
        torch.zeros(b, dtype=torch.int32).data_ptr(),
        torch.empty_like(imgs).data_ptr(),
        torch.empty((b, h, w), dtype=torch.bool).data_ptr(), b, h, w, 63,
        127, None)
    assert err != 0


def blur_inputs(h, w, b=3, seed=0):
    rng = np.random.default_rng(seed + h * 7 + w)
    comp = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8))
    imgs = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8))
    # Holes in runs and single pixels, more in some frames than others.
    cov = torch.from_numpy(rng.random((b, h, w)) > np.array(
        [0.05, 0.3, 0.9])[:b, None, None])
    edge = torch.tensor([3, 0, 11][:b], dtype=torch.int32)
    return comp, cov, imgs, edge


# (h, w, coverage, emulated SMs): the SM count sets the runs of rows per
# strip (2: three runs of 50 rows at 150 x 96; 8: six runs of 23 rows on
# two strips; 30: runs of one row). 384 columns make whole 16-byte-aligned
# strips, the middle one interior: the kernel's four-bytes-a-thread path.
BLUR_CASES = {
    "150x96": (150, 96, None, 2),
    "61x97": (61, 97, None, 2),
    "135x130-two-strips": (135, 130, None, 8),
    "all-covered": (61, 97, "all", 2),
    "none-covered": (61, 97, "none", 2),
    "edge-past-width": (61, 97, "edge", 2),
    "rows-as-many-as-runs": (9, 40, None, 30),
    "aligned-strips-40x384": (40, 384, None, 4),
    "aligned-strips-all-covered": (40, 384, "all", 4),
    "aligned-strips-edge-inside": (40, 384, "edge-mid", 4),
}


@pytest.mark.parametrize("packed", [False, True], ids=["u8", "packed"])
@pytest.mark.parametrize("case", list(BLUR_CASES))
def test_blur_select_source_bit_exact(lib, case, packed, monkeypatch):
    h, w, kind, sms = BLUR_CASES[case]
    monkeypatch.setenv("EMU_SMS", str(sms))
    comp, cov, imgs, edge = blur_inputs(h, w)
    if kind == "all":
        cov[:] = True
    elif kind == "none":
        cov[:] = False
    elif kind == "edge":
        edge = torch.tensor([w, w + 5, 2 * w], dtype=torch.int32)
    elif kind == "edge-mid":  # edges inside the middle strip
        edge = torch.tensor([150, 129, 255], dtype=torch.int32)
    ksize = int(np.round(0.0036 * h))
    got = blur_select(lib, comp, cov, imgs, edge, ksize, 3.0, packed)
    if packed:
        want = blur_select_sbs_packed_plain(comp, cov, imgs, edge, ksize,
                                            3.0).view(torch.int32)
    else:
        want = blur_select_sbs_plain(comp, cov, imgs, edge, ksize, 3.0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("w", [150, 384])
@pytest.mark.parametrize("ksize", [2, 8])
def test_blur_select_source_wide_windows(lib, ksize, w):
    """Windows of (7, 5) and of 2160p's (19, 17) on 23-row frames: reflect
    padding at every edge, a frame barely taller than the window; 384
    columns take the staged warps' path away from the side edges."""
    comp, cov, imgs, edge = blur_inputs(23, w, b=2, seed=ksize)
    got = blur_select(lib, comp, cov, imgs, edge, ksize, 3.0, False)
    want = blur_select_sbs_plain(comp, cov, imgs, edge, ksize, 3.0)
    assert torch.equal(got, want)


# --- rows 2 and 17 at any head dim (csrc/attention_any.cu) ----------------

def attention_any(lib, q, k, v, scale, flash):
    b, n, h, d = q.shape
    o = torch.empty((b, n, h, d), dtype=q.dtype)
    err = lib.vrvg_attention_any(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, h, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), o.stride(0), o.stride(1), scale, int(flash),
        int(q.dtype == torch.float32), None)
    assert err == 0
    return o


# Against the plain versions on the same operands: at f32 only the sums'
# order differs (measured: at most 3.7e-7 of max |o|; with the real blocks
# at 4200 keys, nine 512-key blocks each rescaling the output, max 4.3e-7
# and mean 3.6e-7 of mean |o|); at bf16 a probability or an output may
# round to the neighbouring bf16 value, one ulp, 2^-8 of the value
# (measured: equal bit for bit but at Dh = 256, 2.2e-4 of max |o|, and in
# SMALL_BLOCKS' blocks 2.0e-5).
ANY_BOUNDS = {torch.float32: (2e-6, 1e-6), torch.bfloat16: (4e-3, 4e-4)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def attention_any_case(lib, d, flash, n, dtype, b=2, heads=2):
    """q, k and v as views into one (B, N, 3, H, Dh) qkv (an odd head dim's
    rows 2-byte aligned only), peaked so that a key past N that the kernel
    failed to mask would weigh as much as e^4 real ones (attention_bench's
    q/k/v): max and mean error against max / mean |o| of the plain version
    within ANY_BOUNDS."""
    gen = torch.Generator().manual_seed(d)
    qkv = peaked_qkv(gen, b, n, heads, dtype, head_dim=d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scale = d ** -0.5
    if flash:
        got = attention_any(lib, q, k, v, scale, True)
        want = flash_attention_plain(q, k, v, scale)
    else:
        qs = (q.float() * scale).to(dtype)
        got = attention_any(lib, qs, k, v, 1.0, False)
        want = attention_plain(qs, k, v)
    stats = error_stats(got, want)
    max_rel, mean_rel = ANY_BOUNDS[dtype]
    assert stats["max_rel_err"] <= max_rel and \
        stats["mean_rel_err"] <= mean_rel, stats


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("d,flash", [(16, False), (20, False), (48, False),
                                     (128, False), (256, False), (17, True),
                                     (128, True)])
def test_attention_any_source_matches_plain(lib, d, flash, dtype):
    """Rows 2 and 17 at N = 70: two 64-row q tiles and two key tiles, both
    ragged (attention_any_case)."""
    attention_any_case(lib, d, flash, 70, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_attention_any_source_walks_flash_blocks(small_blocks, dtype,
                                                 monkeypatch):
    """Row 17 past its one-block length in SMALL_BLOCKS' blocks (300 keys:
    128, 128 and a ragged 44), each block's probabilities against the
    running maximum and the output rescaled a block, against the plain
    version with the same blocks (attention_any_case)."""
    for name, value in SMALL_BLOCKS.items():
        monkeypatch.setattr(attn_ops, name, value)
    attention_any_case(small_blocks, 24, True, 300, dtype, b=1)


def test_attention_any_source_refuses_head_dim_257(lib):
    q = torch.zeros((1, 3, 1, 257))
    err = lib.vrvg_attention_any(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), q.data_ptr(), 1, 3, 1, 257,
        771, 257, 771, 257, 771, 257, 771, 257, 1.0, 0, 1, None)
    assert err != 0
