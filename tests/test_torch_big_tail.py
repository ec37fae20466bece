"""PyTorch port on the CPU: the big-C DPT tail (rows 11 and 12) stage by
stage, as the card runs it. The front is an upsample pass, then conv1 as an
implicit GEMM on the TMA + wgmma core; the back a resize pass, then conv2
with the 1x1 in registers. Their plain stages, composed, are the whole plain
versions the kernels were held against before the stages existed (kept here
as they were) bit for bit, and the composition matches the JAX package's
``head_tail_big_pallas`` in interpret mode. A pure-torch emulation of the
row-11 kernel's tile loop, with the tap -> coordinate mapping and the (C2,
9 C) weights the wrapper hands it, and zero fill outside the image, equals
``F.conv2d`` with zero padding exactly; so does an emulation of the row-12
kernel's halo tiles with its (9 * 32, C2) weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vr_video_generator_tpu.ops.head_tail_pallas import head_tail_big_pallas
from vr_video_generator_tpu_torch.ops import head_tail as ht

torch.set_num_threads(2)
torch.set_grad_enabled(False)


def _weights(rng, c, dtype):
    """Seeded tail weights in PyTorch layout: out_conv, its bias, conv1, its
    bias, conv2, its bias, the 1x1, its bias."""
    c2, c3 = c // 2, 32
    shapes = [((c, c, 1, 1), c ** -0.5, 0.0), ((c,), 0.1, 0.0),
              ((c2, c, 3, 3), (9 * c) ** -0.5, 0.0), ((c2,), 0.1, 0.0),
              ((c3, c2, 3, 3), (9 * c2) ** -0.5, 0.0), ((c3,), 0.1, 0.0),
              ((1, c3, 1, 1), c3 ** -0.5, 0.0), ((1,), 0.1, 0.5)]
    return [torch.from_numpy((rng.standard_normal(s) * k + o)
                             .astype(np.float32)).to(dtype)
            for s, k, o in shapes]


# The whole plain versions as the kernels were held against them before the
# stages existed: one function each for the front and the back.
def _parent_front_plain(x, k_oc, k1):
    dt = x.dtype
    _, h0, w0, _ = x.shape
    wta = ht._resize_matrix(w0, 2 * w0, dt, x.device)
    rw = torch.einsum("bhwc,vw->bhvc", x.float(), wta).to(dt)
    z = ht._hlerp(rw.float(), 2 * h0, 1).to(dt)
    c1 = F.conv2d(z.permute(0, 3, 1, 2).float(),
                  ht.fold_conv1(k_oc, k1, dt).float(), padding=1)
    return c1.to(dt).permute(0, 2, 3, 1).contiguous()


def _parent_back_plain(mid, k1, b_oc, b1, k2, b2, k3, b3, out_hw):
    dt = mid.dtype
    _, hm, w2, _ = mid.shape
    h1, w1 = out_hw
    zw = torch.einsum("bhwc,vw->bhvc", mid.float(),
                      ht._resize_matrix(w2, w1, dt, mid.device))
    cw = ht.big_tail_bias(k1, b_oc, b1, w2, w1)
    t = zw + cw[0]
    t[:, 0] = t[:, 0] + cw[1]
    t[:, hm - 1] = t[:, hm - 1] + cw[2]
    zz = ht._hlerp(t.to(dt).float(), h1, 1).to(dt)
    y = F.conv2d(zz.permute(0, 3, 1, 2).float(), k2.to(dt).float(), padding=1)
    y = F.relu(b2.float()[None, :, None, None] + y)
    res = (y * k3[0, :, 0, 0].float()[:, None, None]).sum(dim=1) + b3.float()
    return F.relu(res)


# Every width the kernels are built for, odd and ragged grids, f32 and bf16.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h0,w0,c", [(1, 7, 11, 64), (2, 5, 9, 128),
                                       (1, 6, 19, 256), (1, 5, 7, 384)])
def test_big_tail_stages_compose_to_whole_plain(b, h0, w0, c, dtype):
    rng = np.random.default_rng(h0 * w0 + c)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((b, h0, w0, c))
                         .astype(np.float32)).to(dt)
    k_oc, b_oc, k1, b1, k2, b2, k3, b3 = _weights(rng, c, dt)
    out_hw = (h0 * 14 // 4, w0 * 14 // 4)

    u, mid = ht.head_tail_big_front_stages(x, k_oc, k1)
    assert torch.equal(u, ht.big_upsample_plain(x))
    assert u.shape == (b, 2 * h0, 2 * w0, c) and u.dtype == dt
    assert torch.equal(mid, ht.big_conv1_plain(u, k_oc, k1))
    assert torch.equal(mid, _parent_front_plain(x, k_oc, k1))
    assert torch.equal(ht.head_tail_big_front(x, k_oc, k1), mid)

    back = (k1, b_oc, b1, k2, b2, k3, b3, out_hw)
    r, depth = ht.head_tail_big_back_stages(mid, *back)
    assert torch.equal(r, ht.big_resize_plain(mid, k1, b_oc, b1, out_hw))
    assert r.shape == (b, *out_hw, c // 2) and r.dtype == dt
    assert torch.equal(depth, ht.big_conv2_plain(r, k2, b2, k3, b3))
    assert torch.equal(depth, _parent_back_plain(mid, *back))
    assert torch.equal(ht.head_tail_big_back(mid, *back), depth)
    assert depth.dtype == torch.float32


def test_big_tail_stages_match_pallas_interpret():
    """The stages composed, in f32, against head_tail_big_pallas in TPU
    interpret mode within 5e-4 (the JAX package's own bound for the tail,
    tests/test_head_tail.py:115)."""
    rng = np.random.default_rng(3)
    b, h0, w0, c = 2, 20, 32, 256
    h1, w1 = h0 * 14 // 4, w0 * 14 // 4
    x = rng.standard_normal((b, h0, w0, c)).astype(np.float32)
    wts = _weights(rng, c, torch.float32)
    hwio = lambda k: jnp.asarray(k.numpy().transpose(2, 3, 1, 0))
    k_oc, b_oc, k1, b1, k2, b2, k3, b3 = wts
    ref = np.asarray(head_tail_big_pallas(
        jnp.asarray(x), hwio(k_oc), jnp.asarray(b_oc.numpy()), hwio(k1),
        jnp.asarray(b1.numpy()), hwio(k2), jnp.asarray(b2.numpy()), hwio(k3),
        jnp.asarray(b3.numpy()), (h1, w1), interpret=True))
    u, mid = ht.head_tail_big_front_stages(torch.from_numpy(x), k_oc, k1)
    _, ours = ht.head_tail_big_back_stages(mid, k1, b_oc, b1, k2, b2, k3, b3,
                                           (h1, w1))
    assert ours.shape == ref.shape == (b, h1, w1)
    assert np.abs(ours.numpy() - ref).max() <= 5e-4


# How the row-11 kernel reads conv1 as a GEMM (Conv3x3Layout in
# csrc/wgmma_gemm.cuh): a tile of BM GEMM rows is a rectangle of BM / TILE_PX
# image rows by TILE_PX pixels, the tiles along W first; K slice t is 64
# channels of one tap.
TILE_PX = 32


def _conv1_slice(t, c):
    """K slice ``t`` at ``c`` input channels: (dh, dw, first channel)."""
    tap, c0 = divmod(t, c // 64)
    return tap // 3, tap % 3, 64 * c0


def _conv1_tile(t, tiles_x, tiles_y, rows):
    """Tile ``t``: (frame, first row, first pixel)."""
    ty, tx = divmod(t, tiles_x)
    return ty // tiles_y, ty % tiles_y * rows, tx * TILE_PX


def _conv1_tile_loop(u, w1m, bm):
    """Row 11's conv1 as the kernel runs it (csrc/wgmma_gemm.cuh,
    Conv3x3Layout), in f64: a tile of BM GEMM rows is a rectangle of BM / P
    image rows by P = TILE_PX pixels (_conv1_tile); K slice t is 64
    channels of one tap (_conv1_slice), its A tile the box of U at (c0,
    x0 + dw - 1, y0 + dh - 1, frame), zero outside U; B is the wrapper's
    (C2, 9 C) weights; the stored rows and pixels are clipped to the
    image."""
    bsz, h, w, c = u.shape
    p = TILE_PX
    rows = bm // p
    tiles_x, tiles_y = -(-w // p), -(-h // rows)
    out = torch.full((bsz, h, w, w1m.shape[0]), float("nan"),
                     dtype=torch.float64)
    b_mat = w1m.double()
    for tile in range(bsz * tiles_y * tiles_x):
        fb, y0, x0 = _conv1_tile(tile, tiles_x, tiles_y, rows)
        acc = torch.zeros((bm, w1m.shape[0]), dtype=torch.float64)
        for t in range(9 * c // 64):
            dh, dw, c0 = _conv1_slice(t, c)
            a = torch.zeros((rows, p, 64), dtype=torch.float64)
            for i in range(rows):
                y = y0 + i + dh - 1
                for j in range(p):
                    xx = x0 + j + dw - 1
                    if 0 <= y < h and 0 <= xx < w:
                        a[i, j] = u[fb, y, xx, c0:c0 + 64].double()
            acc += a.reshape(bm, 64) @ b_mat[:, 64 * t:64 * t + 64].T
        acc = acc.reshape(rows, p, -1)
        ny, nx = min(rows, h - y0), min(p, w - x0)
        out[fb, y0:y0 + ny, x0:x0 + nx] = acc[:ny, :nx]
    return out


# Ragged widths and heights (W2 = 38 and 70 against 32-pixel tiles, H = 3,
# 10 and 6 against 8- and 4-row ones), each tile shape the wrapper picks (256
# x 128 up to C2 = 128, 128 x 192 at 192).
@pytest.mark.parametrize("b,h,w,c,bm", [(1, 3, 38, 64, 256),
                                        (2, 10, 70, 128, 256),
                                        (1, 6, 38, 384, 128)])
def test_conv1_tile_loop_equals_conv2d(b, h, w, c, bm):
    """Small integers in U, an identity out_conv and integer conv1 weights:
    every product and sum is exact, so the tile loop must equal F.conv2d
    with zero padding bit for bit, the first and last image rows and the
    ragged last tiles included."""
    rng = np.random.default_rng(c + w)
    c2 = c // 2
    u = torch.from_numpy(rng.integers(-3, 4, (b, h, w, c)).astype(np.float32))
    k_oc = torch.eye(c)[:, :, None, None]
    k1 = torch.from_numpy(rng.integers(-2, 3, (c2, c, 3, 3))
                          .astype(np.float32))
    w1m = ht.conv1_weights(k_oc, k1)
    assert w1m.shape == (c2, 9 * c) and w1m.dtype == torch.bfloat16
    got = _conv1_tile_loop(u, w1m, bm)
    want = F.conv2d(u.permute(0, 3, 1, 2).double(), k1.double(),
                    padding=1).permute(0, 2, 3, 1)
    assert torch.equal(got[:, 0], want[:, 0])
    assert torch.equal(got[:, h - 1], want[:, h - 1])
    assert torch.equal(got, want)


def _conv2_halo_tiles(r, w2m, tr=2, tw=128):
    """Row 12's conv2 as the kernel runs it (csrc/head_tail_big.cu,
    conv2_kernel), in f64: tiles of tr rows x tw pixels; for each 64-channel
    chunk one halo box of R from (x0 - 1, y0 - 1), (tr + 2) rows of tw + 2
    pixels, zero outside R and past C2, flattened in (row, pixel) order; the
    output at (rr, px) sums, over taps (dh, dw), halo pixel (rr + dh) (tw +
    2) + px + dw against weight rows (3 dh + dw) 32 + n."""
    bsz, h, w, c2 = r.shape
    chunks = -(-c2 // 64)
    wts = torch.zeros((9 * 32, 64 * chunks), dtype=torch.float64)
    wts[:, :c2] = w2m.double()
    out = torch.zeros((bsz, h, w, 32), dtype=torch.float64)
    for fb in range(bsz):
        for y0 in range(0, h, tr):
            for x0 in range(0, w, tw):
                acc = torch.zeros((tr, tw, 32), dtype=torch.float64)
                for ch in range(chunks):
                    halo = torch.zeros((tr + 2, tw + 2, 64),
                                       dtype=torch.float64)
                    for i in range(tr + 2):
                        y = y0 - 1 + i
                        if not 0 <= y < h:
                            continue
                        xa, xb = max(x0 - 1, 0), min(x0 - 1 + tw + 2, w)
                        hi = min(64 * ch + 64, c2)
                        halo[i, xa - (x0 - 1):xb - (x0 - 1), :hi - 64 * ch] = \
                            r[fb, y, xa:xb, 64 * ch:hi].double()
                    flat = halo.reshape(-1, 64)
                    for tap in range(9):
                        dh, dw = divmod(tap, 3)
                        wt = wts[32 * tap:32 * tap + 32, 64 * ch:64 * ch + 64]
                        for rr in range(tr):
                            idx = (rr + dh) * (tw + 2) + dw + torch.arange(tw)
                            acc[rr] += flat[idx] @ wt.T
                ny, nx = min(tr, h - y0), min(tw, w - x0)
                out[fb, y0:y0 + ny, x0:x0 + nx] = acc[:ny, :nx]
    return out


# Ragged tiles in both directions (rows 5 and 3 against 2-row tiles; 130
# and 37 pixels against 128), one and three 64-channel chunks, and C2 = 32,
# half a chunk.
@pytest.mark.parametrize("b,h,w,c2", [(1, 5, 130, 64), (1, 3, 37, 192),
                                      (2, 4, 20, 32)])
def test_conv2_halo_tiles_equal_conv2d(b, h, w, c2):
    rng = np.random.default_rng(h * w + c2)
    r = torch.from_numpy(rng.integers(-3, 4, (b, h, w, c2)).astype(np.float32))
    k2 = torch.from_numpy(rng.integers(-2, 3, (32, c2, 3, 3))
                          .astype(np.float32))
    w2m = ht.conv2_weights(k2)
    assert w2m.shape == (9 * 32, c2) and w2m.dtype == torch.bfloat16
    got = _conv2_halo_tiles(r, w2m)
    want = F.conv2d(r.permute(0, 3, 1, 2).double(), k2.double(),
                    padding=1).permute(0, 2, 3, 1)
    assert torch.equal(got, want)
