"""PyTorch port on the CPU: the ext DPT tail (row 7) stage by stage, as the
card runs it: the out_conv mix, the upsample pass with the out_conv bias,
conv1 with its f32 bias before the cast, the resize pass, and conv2 with the
1x1. Their plain stages, composed, are the whole plain version the kernels
were held against before the stages existed (kept here as it was) bit for
bit, in f32 and bf16, and the composition matches the JAX package's
``head_tail_ext_pallas`` in interpret mode. Pure-torch emulations of the
two conv1 tile loops, fed the weights the wrapper hands each (the GEMM
core's implicit GEMM at C2 = 64 to 192, the halo-tile kernel at C2 = 32),
equal ``F.conv2d`` with zero padding and the bias exactly. The wrapper
builds those weight layouts once per set of weights."""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_big_tail import _conv1_tile_loop, _conv2_halo_tiles
from vr_video_generator_tpu.ops.head_tail_pallas import head_tail_ext_pallas
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


# The whole plain version as the kernels were held against it before the
# stages existed.
def _parent_ext_plain(x, k_oc, b_oc, k1, b1, k2, b2, k3, b3, out_hw):
    dt, f32 = x.dtype, torch.float32
    _, h0, w0, _ = x.shape
    h1, w1 = out_hw
    xoc = (x.float() @ k_oc[:, :, 0, 0].to(dt).float().T).to(dt)
    wta = ht._resize_matrix(w0, 2 * w0, dt, x.device)
    rw = torch.einsum("bhwc,vw->bhvc", xoc.float(), wta).to(dt)
    z = (ht._hlerp(rw.float(), 2 * h0, 1) + b_oc.to(f32)).to(dt)
    c1 = F.conv2d(z.permute(0, 3, 1, 2).float(), k1.to(dt).float(),
                  b1.to(f32), padding=1).to(dt)
    wtb = ht._resize_matrix(c1.shape[3], w1, dt, c1.device)
    c1w = torch.einsum("bchw,vw->bchv", c1.float(), wtb).to(dt)
    zz = ht._hlerp(c1w.float(), h1, 2).to(dt)
    y = F.conv2d(zz.float(), k2.to(dt).float(), padding=1)
    y = F.relu(y + b2.to(f32)[:, None, None])
    res = (y * k3[0, :, 0, 0].to(f32)[:, None, None]).sum(dim=1) + b3.to(f32)
    return F.relu(res)


# Every width the kernels take (C = 32 on the older chain), odd and ragged
# grids, f32 and bf16.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h0,w0,c", [(1, 7, 11, 64), (2, 5, 9, 128),
                                       (1, 6, 19, 256), (1, 5, 7, 384),
                                       (2, 6, 10, 32)])
def test_ext_tail_stages_compose_to_whole_plain(b, h0, w0, c, dtype):
    rng = np.random.default_rng(h0 * w0 + c)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((b, c, h0, w0))
                         .astype(np.float32)).to(dt).permute(0, 2, 3, 1)
    wts = _weights(rng, c, dt)
    k_oc, b_oc, k1, b1, k2, b2, k3, b3 = wts
    out_hw = (h0 * 14 // 4, w0 * 14 // 4)
    hm, w2 = 2 * h0, 2 * w0

    xoc, z, c1, r, depth = ht.head_tail_ext_stages(x, *wts, out_hw)
    assert torch.equal(xoc, ht.ext_mix_plain(x, k_oc))
    assert torch.equal(z, ht.big_upsample_plain(xoc, b_oc))
    assert torch.equal(c1, ht.ext_conv1_plain(z, k1, b1))
    assert torch.equal(r, ht.ext_resize_plain(c1, out_hw))
    assert torch.equal(depth, ht.big_conv2_plain(r, k2, b2, k3, b3))
    for t, shape in ((xoc, (b, h0, w0, c)), (z, (b, hm, w2, c)),
                     (c1, (b, hm, w2, c // 2)), (r, (b, *out_hw, c // 2))):
        assert t.shape == shape and t.dtype == dt
    assert depth.shape == (b, *out_hw) and depth.dtype == torch.float32
    assert torch.equal(depth, _parent_ext_plain(x, *wts, out_hw))
    assert torch.equal(ht.head_tail_ext_plain(x, *wts, out_hw), depth)
    assert torch.equal(ht.head_tail_ext(x, *wts, out_hw), depth)
    # The upsample pass without the bias is row 11's, and one with a zero
    # bias gives the same values.
    assert torch.equal(ht.big_upsample_plain(xoc, torch.zeros_like(b_oc)),
                       ht.big_upsample_plain(xoc))


@pytest.mark.parametrize("b,h0,w0,c", [(2, 12, 20, 64), (1, 8, 12, 256)])
def test_ext_tail_stages_match_pallas_interpret(b, h0, w0, c):
    """The stages composed, in f32, against head_tail_ext_pallas in TPU
    interpret mode within 5e-4 (the JAX package's own bound for the tail,
    tests/test_head_tail.py:92)."""
    rng = np.random.default_rng(11 + c)
    h1, w1 = h0 * 14 // 4, w0 * 14 // 4
    x = rng.standard_normal((b, h0, w0, c)).astype(np.float32)
    wts = _weights(rng, c, torch.float32)
    hwio = lambda k: jnp.asarray(k.numpy().transpose(2, 3, 1, 0))
    k_oc, b_oc, k1, b1, k2, b2, k3, b3 = wts
    ref = np.asarray(head_tail_ext_pallas(
        jnp.asarray(x), hwio(k_oc), jnp.asarray(b_oc.numpy()), hwio(k1),
        jnp.asarray(b1.numpy()), hwio(k2), jnp.asarray(b2.numpy()), hwio(k3),
        jnp.asarray(b3.numpy()), (h1, w1), interpret=True))
    *_, ours = ht.head_tail_ext_stages(torch.from_numpy(x), *wts, (h1, w1))
    assert ours.shape == ref.shape == (b, h1, w1)
    assert np.abs(ours.numpy() - ref).max() <= 5e-4


def _int_conv1(rng, b, h, w, c):
    """Small integers in Z and integer conv1 weights and bias: every product
    and sum is exact in f32 and bf16."""
    c2 = c // 2
    z = torch.from_numpy(rng.integers(-3, 4, (b, h, w, c)).astype(np.float32))
    k1 = torch.from_numpy(rng.integers(-2, 3, (c2, c, 3, 3))
                          .astype(np.float32))
    b1 = torch.from_numpy(rng.integers(-4, 5, (c2,)).astype(np.float32))
    want = F.conv2d(z.permute(0, 3, 1, 2).double(), k1.double(),
                    b1.double(), padding=1).permute(0, 2, 3, 1)
    return z, k1, b1, want


def _ext_conv1_weights(c, k1, b1):
    """conv1's weights as the ext wrapper hands them to the kernels."""
    wts = [torch.zeros((c, c, 1, 1)), torch.zeros(c), k1, b1,
           torch.zeros((32, c // 2, 3, 3)), torch.zeros(32),
           torch.zeros((1, 32, 1, 1)), torch.zeros(1)]
    _, w1m, _, _, b1f, *_ = ht._ext_weights(*wts)
    return w1m, b1f


# conv1 on the GEMM core (C2 = 64 to 192): the tile shape the front picks
# (256 x 128 up to C2 = 128, 128 x 192 at 192), ragged widths and heights
# against 32-pixel tiles of 8 and 4 rows.
@pytest.mark.parametrize("b,h,w,c,bm", [(1, 3, 38, 128, 256),
                                        (2, 10, 70, 256, 256),
                                        (1, 6, 38, 384, 128)])
def test_ext_conv1_core_tile_loop_equals_conv2d(b, h, w, c, bm):
    """The row-11 tile loop (the same Conv3x3Layout) on the (C2, 9 C)
    weights the ext wrapper hands the core, with b1 added to the f32 sums
    before the cast (BiasBeforeCast): F.conv2d with zero padding and the
    bias, bit for bit."""
    rng = np.random.default_rng(c + w)
    z, k1, b1, want = _int_conv1(rng, b, h, w, c)
    w1m, b1f = _ext_conv1_weights(c, k1, b1)
    assert w1m.shape == (c // 2, 9 * c) and w1m.dtype == torch.bfloat16
    assert b1f.dtype == torch.float32
    got = _conv1_tile_loop(z, w1m, bm) + b1f.double()
    assert torch.equal(got[:, 0], want[:, 0])
    assert torch.equal(got[:, h - 1], want[:, h - 1])
    assert torch.equal(got, want)


# conv1 on the halo-tile kernel at C2 = 32 (vits, C = 64): ragged tiles in
# both directions against 2 rows x 128 pixels.
@pytest.mark.parametrize("b,h,w", [(1, 5, 130), (2, 3, 37)])
def test_ext_conv1_halo_tiles_equal_conv2d(b, h, w):
    """The row-12 halo tiles on the (9 * 32, C) weights the ext wrapper
    hands the halo kernel, + b1 in f32 (Conv1Out): F.conv2d with zero
    padding and the bias, bit for bit."""
    rng = np.random.default_rng(h * w)
    z, k1, b1, want = _int_conv1(rng, b, h, w, 64)
    w1m, b1f = _ext_conv1_weights(64, k1, b1)
    assert w1m.shape == (9 * 32, 64) and w1m.dtype == torch.bfloat16
    got = _conv2_halo_tiles(z, w1m) + b1f.double()
    assert torch.equal(got, want)


def test_prepared_weights_built_once_per_weight():
    """The wrappers' weight layouts are built once per set of weights: the
    same tensors give the same prepared tensors; an in-place write of one of
    them rebuilds them; another tensor builds its own; and a freed weight
    drops its entry."""
    rng = np.random.default_rng(0)
    wts = _weights(rng, 64, torch.bfloat16)
    first = ht._prepared(ht._ext_weights, tuple(wts))
    assert ht._prepared(ht._ext_weights, tuple(wts)) is first
    wts[3].add_(1)  # b1
    second = ht._prepared(ht._ext_weights, tuple(wts))
    assert second is not first
    assert torch.equal(second[4], wts[3].float())
    other = list(wts)
    other[2] = wts[2].clone()
    assert ht._prepared(ht._ext_weights, tuple(other)) is not second
    before = len(ht._PREPARED)
    del other
    gc.collect()
    assert len(ht._PREPARED) == before - 1
    # Inference tensors are never kept (their writes are not counted).
    with torch.inference_mode():
        frozen = [w.clone() for w in wts]
    assert ht._prepared(ht._ext_weights, tuple(frozen)) is not \
        ht._prepared(ht._ext_weights, tuple(frozen))


def test_takes_any_row_but_at_32():
    """The five-stage chain takes any grid at every width the JAX kernel
    takes (C a multiple of 16, zero-padded to its widths); only the C = 32
    chain holds a row in shared memory, and a grid too wide for it runs the
    five-stage chain (wmma_takes)."""
    for c in (16, 32, 48, 64, 96, 128, 144, 256, 384, 528):
        assert ht.takes(c)
    assert not ht.takes(40) and not ht.takes(8)
    assert ht.wmma_takes(32, 264) and not ht.wmma_takes(32, 10 ** 5)
    assert not ht.wmma_takes(48, 10) and not ht.wmma_takes(64, 264)
