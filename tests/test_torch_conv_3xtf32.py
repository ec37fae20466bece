"""PyTorch port, rows 11 and 12 at f32: the big-C DPT tail's two convs as
implicit GEMMs on the 3xTF32 wgmma core (csrc/tf32x3_gemm.cuh,
Conv3x3Layout; csrc/head_tail_big.cu, vrvg_head_tail_big_f32), their
arithmetic and indexing on the CPU.

The kernel (TMA, mbarriers, wgmma) runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 8). What it computes is held
here, with g++ building the core's host-and-device headers as they are:
(a) tf32x3::ConvTiles' halo boxes (the TMA box of each 32-channel slice of
    each tile, one pixel and one row past the tile on each side, zeros
    outside the image), the halo row each tap of a GEMM row reads and the
    tile row -> output pixel map rebuild F.unfold's im2col of the image,
    row for row, at a ragged W (528 = 16.5 x 32) and a ragged H, every
    pixel from exactly one tile row; the taps at the image's edges reach
    one pixel past it;
(b) a torch model of the core on that im2col (A and the split weights split
    by tf32x3::split, a fresh truncating tensor-core sum of each 32-wide
    stage, the stages added in f32 in the kernel's order: each slice's nine
    taps, slice by slice) lies within chip_smoke.py's f32 bound
    (F32_MAX_ULPS, f32_exact_check) of the plain conv on f64 operands, for
    conv1 at C = 64, 128, 256 and 384 (C2 = C / 2) and conv2 (32 outputs)
    at C2 = 32, 64, 128 and 192; the same model on TF32 operands is
    refused;
(c) the convs' split planes (ops/head_tail._conv_split) hold each weight
    row as the header's split() does, in the k order the layout reads;
(d) the quad gather of the ROW epilogue (tf32x3::acc_lane, acc_value)
    brings a row's columns to one thread in column order, at every tile
    width;
(e) csrc/epilogue_f32.cuh's depth_out_f32 (the core's DepthOut) equals a
    sequential f32 model of big_conv2_plain's 1x1, bit for bit.
Needs g++ (C++20).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import F32_MAX_ULPS, f32_exact_check, f32_ulps, f64, tf32_round
from tests.test_torch_gemm_3xtf32 import accumulator_columns, core_sums
from vr_video_generator_tpu_torch.kernels.build import CSRC_DIR
from vr_video_generator_tpu_torch.ops import head_tail as ht
from vr_video_generator_tpu_torch.ops import mlp

torch.set_num_threads(2)
torch.set_grad_enabled(False)

EMU_DIR = Path(__file__).resolve().parent / "cuda_emu"
P, R, CK = 32, 4, 32  # tf32x3::ConvTiles: pixels, rows, channels of a box
UNIT = """#include <cuda_runtime.h>
namespace {
alignas(1024) unsigned char smem[emu::SHARED_BYTES];
}
namespace emu {
static unsigned char* shared_memory() { return smem; }
}
#include "tf32x3.cuh"
#include "epilogue_f32.cuh"
extern "C" int conv_tiles(int c, int h, int w, int batch) {
  return tf32x3::ConvTiles{c, h, w, batch}.tiles();
}
extern "C" void conv_halo(int c, int h, int w, int batch, int tile, int cs,
                          int* out) {
  tf32x3::ConvTiles{c, h, w, batch}.halo(tile, cs, out[0], out[1], out[2],
                                         out[3]);
}
extern "C" int halo_row(int r, int tap) {
  return tf32x3::ConvTiles::halo_row(r, tap);
}
extern "C" int conv_pixel(int c, int h, int w, int batch, int tile, int r) {
  return tf32x3::ConvTiles{c, h, w, batch}.pixel(tile, r);
}
extern "C" int acc_lane(int n) { return tf32x3::acc_lane(n); }
extern "C" int acc_value(int n, int i) { return tf32x3::acc_value(n, i); }
extern "C" void split_many(const uint32_t* x, uint32_t* hi, uint32_t* lo,
                           long n) {
  for (long i = 0; i < n; ++i) {
    tf32x3::split(tf32x3::from_bits(x[i]), hi[i], lo[i]);
  }
}
// Each pixel's 32 sums s (n, 32) -> depth by depth_out_f32.
extern "C" void depth_out_many(const float* s, const float* b2,
                               const float* w3, const float* b3, float* out,
                               long n) {
  for (long p = 0; p < n; ++p) {
    const float(&v)[32] = *reinterpret_cast<const float(*)[32]>(s + 32 * p);
    out[p] = vrvg::depth_out_f32(v, b2, w3, b3[0]);
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build csrc/tf32x3.cuh")
    tmp = tmp_path_factory.mktemp("conv_3xtf32")
    (tmp / "unit.cpp").write_text(UNIT)
    so = tmp / "libconv_3xtf32.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         "-ffp-contract=off", "-w", f"-I{CSRC_DIR}", f"-I{EMU_DIR}",
         str(tmp / "unit.cpp"), "-o", str(so)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = ctypes.CDLL(str(so))
    Pt, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    out.conv_tiles.argtypes = [I] * 4
    out.conv_halo.argtypes = [I] * 6 + [Pt]
    out.conv_halo.restype = None
    out.halo_row.argtypes = [I, I]
    out.conv_pixel.argtypes = [I] * 6
    out.acc_lane.argtypes = [I]
    out.acc_value.argtypes = [I, I]
    out.split_many.argtypes = [Pt, Pt, Pt, L]
    out.split_many.restype = None
    out.depth_out_many.argtypes = [Pt] * 5 + [L]
    out.depth_out_many.restype = None
    return out


def seeded(rng, shape, scale=1.0, shift=0.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale + shift).astype(np.float32))


def unfold_rows(x: torch.Tensor) -> torch.Tensor:
    """im2col of x (B, H, W, C) for a 3x3 conv with zero padding: (B H W,
    9 C), column (3 dh + dw) C + c (ops/head_tail.conv3x3_gemm_weights'
    k order)."""
    b, h, w, c = x.shape
    cols = F.unfold(x.permute(0, 3, 1, 2), 3, padding=1)  # (B, C 9, H W)
    return cols.reshape(b, c, 9, h * w).permute(0, 3, 2, 1).reshape(
        b * h * w, 9 * c)


def header_im2col(lib, x: torch.Tensor):
    """The GEMM's A as the kernel reads it: for each tile and 32-channel
    slice, the halo at conv_halo's coordinates (32 channels, 34 pixels, 6
    rows, 1 frame; zeros outside the image), and for each tap the halo rows
    halo_row names as the tile's 128 rows, each row sent to its conv_pixel.
    Returns (A (B H W, 9 C), how many tile rows each pixel got)."""
    b, h, w, c = x.shape
    pad = P + 2
    xp = torch.zeros((b, h + 2 * pad, w + 2 * pad, c))
    xp[:, pad:pad + h, pad:pad + w] = x
    a = torch.full((b * h * w, 9 * c), float("nan"))
    hits = torch.zeros(b * h * w, dtype=torch.int64)
    coords = (ctypes.c_int * 4)()
    taps = [torch.tensor([lib.halo_row(r, tap) for r in range(128)])
            for tap in range(9)]
    for tile in range(lib.conv_tiles(c, h, w, b)):
        pix = torch.tensor([lib.conv_pixel(c, h, w, b, tile, r)
                            for r in range(128)])
        live = pix >= 0
        hits[pix[live]] += 1
        for cs in range(c // CK):
            lib.conv_halo(c, h, w, b, tile, cs, coords)
            c0, x0, y0, f = coords
            halo = xp[f, pad + y0:pad + y0 + R + 2, pad + x0:pad + x0 + P + 2,
                      c0:c0 + CK].reshape(-1, CK)
            for tap in range(9):
                cols = slice(tap * c + c0, tap * c + c0 + CK)
                a[pix[live], cols] = halo[taps[tap]][live]
    return a, hits


# --- (a) the layout ------------------------------------------------------------

@pytest.mark.parametrize("c,b,h,w", [(32, 2, 5, 37), (64, 1, 7, 528),
                                     (128, 2, 4, 33)],
                         ids=["C=32 ragged W and H", "C=64 W=528 H=7",
                              "C=128 one row band"])
def test_boxes_and_row_map_rebuild_unfold(lib, c, b, h, w):
    """(a) Every pixel is one tile row's, and the boxes the header names
    for its K slices hold F.unfold's im2col row of that pixel."""
    rng = np.random.default_rng(c + h + w)
    x = seeded(rng, (b, h, w, c))
    a, hits = header_im2col(lib, x)
    assert bool((hits == 1).all())
    assert lib.conv_tiles(c, h, w, b) == b * -(-h // R) * -(-w // P)
    assert torch.equal(a, unfold_rows(x))


@pytest.mark.parametrize("tap", range(9))
def test_taps_reach_one_pixel_past_the_edges(lib, tap):
    """(a) At W = 528 (16.5 tiles of 32 pixels) and H = 6: a tile's halo
    starts one pixel and one row before it (-1 at the image's edge: the
    padding, read as zeros by TMA), the last tile of a row band's at pixel
    511, reaching past W, and the second band's at row 3; tap (dh, dw) of
    tile row r reads halo row (r / 32 + dh) 34 + r % 32 + dw; the rows of
    the last tile past W, and of the last band past H, map to no pixel."""
    c, b, h, w = 64, 2, 6, 528
    dh, dw = divmod(tap, 3)
    coords = (ctypes.c_int * 4)()
    tx, ty = -(-w // P), -(-h // R)
    for tile, want in ((0, (CK, -1, -1, 0)), (tx - 1, (CK, 511, -1, 0)),
                       (tx * ty + tx * (ty - 1), (CK, -1, 3, 1))):
        lib.conv_halo(c, h, w, b, tile, 1, coords)
        assert tuple(coords) == want
    assert [lib.halo_row(r, tap) for r in range(128)] == [
        (r // P + dh) * (P + 2) + r % P + dw for r in range(128)]
    last = tx - 1
    assert [lib.conv_pixel(c, h, w, b, last, r) >= 0
            for r in range(P)] == [512 + r < w for r in range(P)]
    band = tx * ty + tx * (ty - 1)  # frame 1's second band: rows 4, 5
    assert [lib.conv_pixel(c, h, w, b, band, P * rr) for rr in range(R)] == [
        (h + 4 + rr) * w if 4 + rr < h else -1 for rr in range(R)]


# --- (b) the model of the core against the bounds ----------------------------

CONVS = [("conv1", 64), ("conv1", 128), ("conv1", 256), ("conv1", 384),
         ("conv2", 32), ("conv2", 64), ("conv2", 128), ("conv2", 192)]
IDS = [f"{name} C={c}" for name, c in CONVS]


def conv_case(name: str, c: int, products="3xtf32"):
    """One conv on seeded operands of chip_smoke.py's tail scales, 2 frames
    of 8 x 12 (192 rows, most of them at an edge): (the model's sums, the
    plain conv on f64 operands, the f32 plain conv, the f32 plain conv on
    TF32-rounded weights). conv1: C -> C / 2 (the folded weights' scale);
    conv2: C -> 32."""
    rng = np.random.default_rng(c + 7 * (name == "conv2"))
    n = c // 2 if name == "conv1" else 32
    x = seeded(rng, (2, 8, 12, c))
    k = seeded(rng, (n, c, 3, 3), (9 * c) ** -0.5)
    planes = ht._conv_split(k)
    # The kernel's stage order: each 32-channel slice's nine taps.
    order = torch.tensor([tap * c + cs * CK + j for cs in range(c // CK)
                          for tap in range(9) for j in range(CK)])
    sums = core_sums(unfold_rows(x)[:, order], planes[:, :, order],
                     products)[:, :n].reshape(2, 8, 12, n)
    return (sums, ht.conv3x3_f32_plain(*f64(x, k)),
            ht.conv3x3_f32_plain(x, k), ht.conv3x3_f32_plain(x, tf32_round(k)))


@pytest.mark.parametrize("name,c", CONVS, ids=IDS)
def test_conv_model_within_the_f32_bounds(name, c):
    """(b) The model within F32_MAX_ULPS of the plain conv on f64 operands,
    at least as close to it on average as the f32 plain conv, and the
    TF32-rounded weights' conv refused (chip_smoke.f32_exact_check)."""
    got, exact, plain, tf32_want = conv_case(name, c)
    stats = f32_exact_check(f"{name} C={c}", got, exact, plain, tf32_want, 1)
    assert stats["vs_plain_max_ulps"] <= F32_MAX_ULPS, stats
    print(stats)


@pytest.mark.parametrize("name,c", CONVS[::2], ids=IDS[::2])
def test_tf32_conv_model_fails_the_f32_bounds(name, c):
    """(b) The model on TF32 operands (one product a k-step) is outside
    F32_MAX_ULPS of the f64 reference, as the card's TF32 result must be."""
    got, exact, _, _ = conv_case(name, c, products="tf32")
    ulps = f32_ulps(got, exact, 1)
    print(f"{name} C={c}: TF32 model {ulps.max().item():.1f} ulps at most")
    assert ulps.max().item() > F32_MAX_ULPS


# --- (c) the split planes -----------------------------------------------------

@pytest.mark.parametrize("n,c", [(192, 384), (32, 64)],
                         ids=["conv1 C=384", "conv2 C2=64"])
def test_conv_split_planes_hold_the_header_rows(lib, n, c):
    """(c) ht._conv_split's planes (2, 128 ceil(n / 128), 9 C): row o of
    each is weight o in the k order (3 dh + dw) C + c, split by the
    header's split() (hi, lo), zeros past n."""
    rng = np.random.default_rng(n + c)
    k = seeded(rng, (n, c, 3, 3))
    planes = ht._conv_split(k)
    rows = -(-n // 128) * 128
    assert planes.shape == (2, rows, 9 * c)
    flat = k.permute(0, 2, 3, 1).reshape(n, 9 * c).contiguous()
    u = flat.numpy().view(np.uint32).copy()
    hi, lo = np.empty_like(u), np.empty_like(u)
    lib.split_many(u.ctypes.data, hi.ctypes.data, lo.ctypes.data, u.size)
    got = planes.numpy().view(np.uint32)
    assert np.array_equal(got[0, :n], hi) and np.array_equal(got[1, :n], lo)
    assert not got[:, n:].any()
    assert torch.equal(planes, mlp.tf32x3_weight_plain(flat))


# --- (d) the quad gather -------------------------------------------------------

@pytest.mark.parametrize("bn", [32, 64, 96, 128])
def test_quad_gather_keeps_the_column_order(lib, bn):
    """(d) For each row (i = 0, 1) of a quad, value acc_value(n, i) of lane
    acc_lane(n) is column n of that row in the wgmma accumulator layout,
    for n = 0 .. BN - 1: the gathered row is in column (channel) order, and
    it takes each of the row's values once."""
    for i in range(2):
        seen = set()
        for n in range(bn):
            lane, value = lib.acc_lane(n), lib.acc_value(n, i)
            assert 0 <= lane < 4 and 0 <= value < bn // 2
            assert accumulator_columns(lane)[value] == n
            assert value % 4 // 2 == i
            seen.add((lane, value))
        assert len(seen) == bn


# --- (e) the depth epilogue ----------------------------------------------------

@pytest.mark.parametrize("spread", [1.0, 30.0])
def test_depth_out_matches_simt_and_sequential(lib, spread):
    """(e) depth_out_f32 on a pixel's 32 sums equals a sequential f32 model
    (b2 + s, ReLU, w3 y added in channel order from 0, + b3, ReLU) bit for
    bit; most pixels live, some ReLU'd to 0."""
    rng = np.random.default_rng(int(spread))
    s = seeded(rng, (4096, 32), spread)
    b2, w3 = seeded(rng, (32,), 0.3, 0.2), seeded(rng, (32,), 0.3)
    b3 = torch.tensor([0.4])
    got = torch.empty(4096)
    args = [t.data_ptr() for t in (s, b2, w3, b3)]
    lib.depth_out_many(*args, got.data_ptr(), 4096)
    y = torch.relu(b2 + s).numpy()
    acc = np.zeros(4096, np.float32)
    for ch in range(32):
        acc = acc + y[:, ch] * w3.numpy()[ch]
    want = torch.relu(torch.from_numpy(acc) + b3)
    assert torch.equal(got, want)
    assert 0.1 < (got > 0).float().mean().item() < 1.0
    near = big_conv2_1x1(s, b2, w3, b3)
    assert (got - near).abs().max().item() <= 1e-5 * near.abs().max().item()


def big_conv2_1x1(s, b2, w3, b3):
    """ops/head_tail.big_conv2_plain's epilogue on the sums s (pixels, 32)."""
    y = F.relu(b2 + s)
    return F.relu((y * w3).sum(dim=1) + b3)
