"""PyTorch port on the CPU: refinenet1's RCU pair (row 16) as the card now
runs it, four 3x3 convs on the TMA + wgmma GEMM core. The chain's plain
stages with the ReLU copies it now hands between convs (relu(t) written
beside t by conv2a, read by conv1b as it is) equal the four plain convs of
the TPU kernel's order bit for bit; and a pure-torch emulation of the core's
conv (csrc/wgmma_gemm.cuh Conv3x3Layout on the tiles csrc/rcu_pair.cu picks:
256 pixels by 64 channels at C = 64, 128 pixels by 128 channels at C = 128;
the weights the wrapper hands it, zero fill outside the image)
and of the convs' f32 step (csrc/rcu_pair.cu RcuSums: the pixel of each
GEMM row, the bias, the ReLU, the residuals) equals ``F.conv2d`` and
``rcu_conv_plain`` exactly on integer data; with the weight layout permuted
it does not."""

import pathlib
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vr_video_generator_tpu_torch.attic import refinenet_pre as rp

torch.set_num_threads(2)
torch.set_grad_enabled(False)

# Conv3x3Layout: a tile of BM GEMM rows is BM / P image rows by P pixels,
# tiles along W, then H, then the frames; K slice t is 64 channels of tap
# t // (C / 64). The RCU convs take BM = 256 (8 image rows) at C = 64 and
# BM = 128 (4 rows) at C = 128, each tile all C channels wide.
P = 32
TILE_BM = {64: 256, 128: 128}
RCU_SRC = (pathlib.Path(rp.__file__).resolve().parents[1] / "csrc"
           / "rcu_pair.cu")


def _pixel(row, h, w, tiles_x, tiles_y, bm):
    """RcuSums::pixel: the pixel (b H + y) W + x of GEMM row ``row`` on
    ``bm``-row tiles, or -1 past the image."""
    tile, r = divmod(row, bm)
    ty, tx = divmod(tile, tiles_x)
    y, x = ty % tiles_y * (bm // P) + r // P, tx * P + r % P
    if y >= h or x >= w:
        return -1
    return (ty // tiles_y * h + y) * w + x


def _core_conv(u, wt):
    """The core's f64 sums of a 3x3 conv of u (B, H, W, C) with B operand
    ``wt`` (N, 9 C): per tile and K slice, the A tile is the box of u at
    (c0, x0 + dw - 1, y0 + dh - 1, frame), zero outside u, on the tiles of
    ``TILE_BM[C]`` rows. Returns the sums by GEMM row, (tiles * BM, N), and
    the tile grid."""
    bsz, h, w, c = u.shape
    bm = TILE_BM[c]
    rows = bm // P
    tiles_x, tiles_y = -(-w // P), -(-h // rows)
    # Zero fill: one pixel of padding, and past the last tile's overhang.
    up = torch.zeros((bsz, tiles_y * rows + 2, tiles_x * P + 2, c),
                     dtype=torch.float64)
    up[:, 1:h + 1, 1:w + 1] = u.double()
    b_mat = wt.double()
    sums = []
    for tile in range(bsz * tiles_y * tiles_x):
        ty, tx = divmod(tile, tiles_x)
        fb, y0, x0 = ty // tiles_y, ty % tiles_y * rows, tx * P
        acc = torch.zeros((bm, wt.shape[0]), dtype=torch.float64)
        for t in range(9 * c // 64):
            tap, cs = divmod(t, c // 64)
            dh, dw, c0 = tap // 3, tap % 3, 64 * cs
            a = up[fb, y0 + dh:y0 + dh + rows, x0 + dw:x0 + dw + P,
                   c0:c0 + 64]
            acc += a.reshape(bm, 64) @ b_mat[:, 64 * t:64 * t + 64].T
        sums.append(acc)
    return torch.cat(sums), tiles_x, tiles_y


def _rcu_conv_emulated(x, wt, bias, relu, residuals=()):
    """One RCU conv as the card computes it: the core's sums, then
    RcuSums::f32_step at each GEMM row's pixel (+ bias, ReLU, the residuals
    in order), the rows past the image clipped by the store; f64 (exact on
    small integers), shaped (B, H, W, C)."""
    bsz, h, w, c = x.shape
    sums, tiles_x, tiles_y = _core_conv(x, wt)
    out = torch.full((bsz * h * w, c), float("nan"), dtype=torch.float64)
    flat = [r.reshape(-1, c).double() for r in residuals]
    for row in range(sums.shape[0]):
        p = _pixel(row, h, w, tiles_x, tiles_y, TILE_BM[c])
        if p < 0:
            continue
        v = sums[row] + bias.double()
        if relu:
            v = v.clamp_min(0)
        for r in flat:
            v = v + r[p]
        out[p] = v
    return out.reshape(bsz, h, w, c)


def _ints(rng, shape, lo, hi):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.float32))


# Ragged grids against the tiles of both widths (H = 3, 10, 9 against 8
# rows at C = 64 and 4 at C = 128; W = 38, 70, 33 against 32 pixels).
GRIDS = [(1, 3, 38, 64), (2, 10, 70, 128), (1, 9, 33, 64), (1, 3, 38, 128),
         (2, 10, 70, 64), (1, 9, 33, 128)]


def test_rcu_emulated_tiles_are_the_kernels():
    """The emulation's tile at each width is the one vrvg_rcu_conv
    dispatches to: Tile<BM, C> for C = 64, then for C = 128."""
    tiles = re.findall(r"run<tma_gemm::Tile<(\d+), (\d+)>>",
                       RCU_SRC.read_text())
    assert [(int(m), int(n)) for m, n in tiles] == [
        (TILE_BM[c], c) for c in (64, 128)]


@pytest.mark.parametrize("b,h,w,c", GRIDS)
def test_rcu_core_tile_loop_equals_conv2d(b, h, w, c):
    """Small integers in x and the weights: every product and sum is exact,
    so the emulated core conv on the wrapper's (C, 9 C) weights must equal
    F.conv2d with zero padding bit for bit, the edge rows and the ragged
    last tiles included."""
    rng = np.random.default_rng(c + w)
    x = _ints(rng, (b, h, w, c), -3, 4)
    k = _ints(rng, (c, c, 3, 3), -2, 3)
    wt, bias = rp._rcu_weights(k, torch.zeros(c))
    assert wt.shape == (c, 9 * c) and wt.dtype == torch.bfloat16
    assert bias.dtype == torch.float32
    got = _rcu_conv_emulated(x, wt, bias, False)
    want = F.conv2d(x.permute(0, 3, 1, 2).double(), k.double(),
                    padding=1).permute(0, 2, 3, 1)
    assert torch.equal(got[:, 0], want[:, 0])
    assert torch.equal(got[:, h - 1], want[:, h - 1])
    assert torch.equal(got, want)


@pytest.mark.parametrize("c", [64, 128])
def test_rcu_core_permuted_weights_fail(c):
    """The emulation catches a wrong B layout: PyTorch's own (O, I * 9)
    order (k = 9 c + tap) in place of the core's (k = tap C + c)."""
    rng = np.random.default_rng(c)
    x = _ints(rng, (1, 9, 33, c), -3, 4)
    k = _ints(rng, (c, c, 3, 3), -2, 3)
    wrong = k.reshape(c, 9 * c).to(torch.bfloat16)
    got = _rcu_conv_emulated(x, wrong, torch.zeros(c), False)
    want = F.conv2d(x.permute(0, 3, 1, 2).double(), k.double(),
                    padding=1).permute(0, 2, 3, 1)
    assert not torch.equal(got, want)


@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("relu,nres", [(True, 0), (False, 2), (False, 1)])
def test_rcu_f32_step_emulation_equals_plain_conv(relu, nres, c):
    """The chain's three kinds of conv (ReLU without residuals, two
    residuals, one) through the emulated core and f32 step, on a relu'd
    input where the conv has a ReLU (the ReLU pass's or conv2a's copy),
    equal rcu_conv_plain exactly on integer data."""
    rng = np.random.default_rng(10 * nres + relu + c)
    b, h, w = 2, 10, 70
    x = _ints(rng, (b, h, w, c), -3, 4)
    k = _ints(rng, (c, c, 3, 3), -2, 3)
    bias = _ints(rng, (c,), -8, 9)
    res = [_ints(rng, (b, h, w, c), -50, 51) for _ in range(nres)]
    wt, bf32 = rp._rcu_weights(k, bias)
    got = _rcu_conv_emulated(F.relu(x) if relu else x, wt, bf32, relu, res)
    want = rp.rcu_conv_plain(x, k, bias, relu, res)
    assert torch.equal(got.float(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 128])
def test_rcu_relu_copy_chain_equals_plain_convs(c, dtype):
    """rcu_chain with conv2a's ReLU copy handed to conv1b (relu_done) is,
    through the plain stages, the TPU kernel's four convs bit for bit; the
    copy is the ReLU of conv2a's output, and a conv on a relu'd input with
    relu_done equals the same conv taking the ReLU itself."""
    rng = np.random.default_rng(c)
    rn0, path2 = (torch.from_numpy(rng.standard_normal((2, 7, 33, c)).astype(
        np.float32)).to(dtype) for _ in range(2))
    ws = []
    for _ in range(4):
        ws += [torch.from_numpy((rng.standard_normal((c, c, 3, 3))
                                 * (9 * c) ** -0.5).astype(np.float32)),
               torch.from_numpy((0.1 * rng.standard_normal(c)).astype(
                   np.float32))]
    k1a, b1a, k2a, b2a, k1b, b1b, k2b, b2b = ws
    conv = rp.rcu_conv_plain
    rb = conv(rn0, k1a, b1a, True)
    t = conv(rb, k2a, b2a, False, (rn0, path2))
    rd = conv(t, k1b, b1b, True)
    want = conv(rd, k2b, b2b, False, (t,))
    t2, t_relu = conv(rb, k2a, b2a, False, (rn0, path2), relu_copy=True)
    assert torch.equal(t2, t) and torch.equal(t_relu, F.relu(t))
    assert torch.equal(conv(t_relu, k1b, b1b, True, relu_done=True), rd)
    got = rp.refinenet_pre_plain(rn0, path2, *ws)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(rp.refinenet_pre(rn0, path2, *ws), want)


def test_rcu_plain_relu_done_refuses_negative_input():
    """relu_done says x is relu'd already; the plain version reads it as it
    is, as the kernel does, and refuses a negative value rather than
    computing what the kernel would not."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 4, 9, 64)).astype(np.float32))
    k = torch.from_numpy(0.05 * rng.standard_normal((64, 64, 3, 3)).astype(
        np.float32))
    b = torch.zeros(64)
    with pytest.raises(ValueError, match="relu_done"):
        rp.rcu_conv_plain(x, k, b, True, relu_done=True)
    with pytest.raises(ValueError, match="relu_done"):
        rp.rcu_conv(x, k, b, True, relu_done=True)
    assert torch.equal(rp.rcu_conv_plain(F.relu(x), k, b, True, relu_done=True),
                       rp.rcu_conv_plain(x, k, b, True))
