"""PyTorch port, slice 5 on the CPU: the two TPU kernels no CLI path runs.
The single-kernel DPT tail (row 15, head_tail_pallas) and refinenet1's
fused RCU pair (row 16, attic refinenet_pre_pallas) against the JAX
package's Pallas kernels in interpret mode, in f32 at the JAX tests' bounds
and in bf16 at the tails' bounds of tests/test_torch_vitg.py, and the chain
RCU pair -> ext tail against refinenet_pre_pallas ->
head_tail_ext_pallas(channel_major_halo=True)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vr_video_generator_tpu.attic.refinenet_pre import (refinenet_pre_pallas,
                                                        rcu_pick_block_rows)
from vr_video_generator_tpu.ops.head_tail_pallas import (head_tail_ext_pallas,
                                                         head_tail_pallas)
from vr_video_generator_tpu_torch.attic import refinenet_pre as rp
from vr_video_generator_tpu_torch.ops import head_tail as ht

torch.set_num_threads(2)
torch.set_grad_enabled(False)

# The bf16 bounds of tests/test_torch_vitg.py (share of the output's range).
BF16_MAX_REL, BF16_MEAN_REL = 2e-3, 2e-4


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _hwio(k, dtype):
    """A JAX (kh, kw, I, O) kernel as PyTorch's (O, I, kh, kw)."""
    return _t(np.asarray(k).transpose(3, 2, 0, 1), dtype)


def _arrays(rng, specs, jdt):
    """numpy-seeded arrays of (shape, scale, shift), rounded to ``jdt`` and
    held in f32 so both packages start from the same values."""
    return [np.asarray(jnp.asarray(rng.standard_normal(s) * k + o, jdt)
                       .astype(jnp.float32)) for s, k, o in specs]


def _assert_close(ours, ref, dtype, f32_atol, bf16_features=False):
    """f32 within ``f32_atol``; bf16 within the tails' share of the range.
    The RCU pair's bf16 features (``bf16_features``) are held by their mean
    in the same way, and, since one bf16 ulp at their largest values is
    already ~2e-3 of their range, their largest difference to 2 ulps of
    their largest magnitude, with at most 1% of them differing (the dense
    kernels' bounds, chip_smoke.py GEMM_MAX_FRAC)."""
    err = np.abs(ours.astype(np.float32) - ref.astype(np.float32))
    if dtype == "float32":
        assert err.max() <= f32_atol, err.max()
        return
    span = float(ref.max() - ref.min())
    assert err.mean() <= BF16_MEAN_REL * span, (err.mean(), span)
    if bf16_features:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        assert err.max() <= 2 * ulp, (err.max(), ulp)
        assert (err > 0).mean() <= 0.01, (err > 0).mean()
    else:
        assert err.max() <= BF16_MAX_REL * span, (err.max(), span)


# --- row 15: the single-kernel DPT tail -------------------------------------

def _tail_args(rng, b, h2, w2, c, jdt):
    c2, c3 = c // 2, 32
    return _arrays(rng, [((b, h2, w2, c), 1.0, 0.0),
                         ((3, 3, c, c2), (9 * c) ** -0.5, 0.0),
                         ((c2,), 0.1, 0.0),
                         ((3, 3, c2, c3), (9 * c2) ** -0.5, 0.0),
                         ((c3,), 0.1, 0.0), ((1, 1, c3, 1), c3 ** -0.5, 0.0),
                         ((1,), 0.1, 0.5)], jdt)


def _port_tail(args, tdt, out_hw):
    x, k1, b1, k2, b2, k3, b3 = args
    return ht.head_tail(_t(x, tdt), _hwio(k1, tdt), _t(b1, tdt),
                        _hwio(k2, tdt), _t(b2, tdt), _hwio(k3, tdt),
                        _t(b3, tdt), out_hw)


# Each path1 width the kernel takes (vits' 64, vitb's 128, and 32), on grids
# whose H1 is no multiple of the TPU kernel's 32-row block.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h2,w2,c", [(40, 64, 32), (72, 128, 64),
                                     (24, 40, 128)])
def test_head_tail_matches_pallas_interpret(h2, w2, c, dtype):
    """head_tail (its plain version on the CPU) against head_tail_pallas
    (interpret mode): f32 within 2e-4 (tests/test_head_tail.py), bf16
    within the tails' share of the depth range. It is the plain version
    and the ext tail's back half."""
    h1, w1 = h2 * 14 // 8, w2 * 14 // 8
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    args = _tail_args(np.random.default_rng(h2 * w2 + c), 2, h2, w2, c, jdt)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(head_tail_pallas(
            jnp.asarray(args[0], jdt), *(jnp.asarray(a, jdt) for a in args[1:]),
            (h1, w1), interpret=True))
    ours = _port_tail(args, tdt, (h1, w1))
    assert ours.dtype == torch.float32 and ours.shape == ref.shape == (2, h1, w1)
    _assert_close(ours.numpy(), ref, dtype, 2e-4)
    x, k1, b1, k2, b2, k3, b3 = args
    np.testing.assert_array_equal(
        ours.numpy(), ht.head_tail_plain(
            _t(x, tdt), _hwio(k1, tdt), _t(b1, tdt), _hwio(k2, tdt),
            _t(b2, tdt), _hwio(k3, tdt), _t(b3, tdt), (h1, w1)).numpy())


def test_head_tail_widths():
    """The kernel takes path1 at every C the JAX kernel takes (C2 = C / 2 a
    multiple of 8, C3 = 32; zero-padded on the card), vitl's and vitg's
    widths too; not at C2 % 8 != 0."""
    assert [c for c in (8, 16, 32, 40, 64, 128, 256, 264, 384)
            if ht.takes(c, "base")] == [16, 32, 64, 128, 256, 384]


# --- row 16: refinenet1's RCU pair -------------------------------------------

def _rcu_args(rng, b, h0, w0, c, jdt):
    specs = [((b, h0, w0, c), 1.0, 0.0), ((b, h0, w0, c), 1.0, 0.0)]
    for _ in range(4):
        specs += [((3, 3, c, c), (9 * c) ** -0.5, 0.0), ((c,), 0.1, 0.0)]
    return _arrays(rng, specs, jdt)


def _port_rcu(args, tdt):
    rn0, path2, *ws = args
    return rp.refinenet_pre(
        _t(rn0, tdt), _t(path2, tdt),
        *(_hwio(w, tdt) if w.ndim == 4 else _t(w, tdt) for w in ws))


def _pallas_rcu_nhwc(args, jdt, block_rows):
    """refinenet_pre_pallas's channel-major (B, H0, C, W0P) output, its
    4-column halo dropped, as NHWC."""
    w0 = args[0].shape[2]
    out = refinenet_pre_pallas(*(jnp.asarray(a, jdt) for a in args),
                               block_rows=block_rows, interpret=True)
    return np.asarray(jnp.transpose(out[:, :, :, 4:4 + w0], (0, 1, 3, 2))
                      .astype(jnp.float32))


# The JAX test's geometries (C = 16, 8) and vits' and vitb's widths, H0 no
# multiple of the row block.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h0,w0,c,r", [(36, 64, 16, 16), (20, 48, 8, 32),
                                       (22, 40, 64, 16), (14, 24, 128, 8)])
def test_refinenet_pre_matches_pallas_interpret(h0, w0, c, r, dtype):
    """rcu2(path2 + rcu1(rn0)) (the plain version on the CPU) against
    refinenet_pre_pallas (interpret mode): f32 within 3e-4
    (tests/test_head_tail.py), bf16 as bf16 features (``_assert_close``);
    the port returns NHWC."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    args = _rcu_args(np.random.default_rng(h0 * w0 + c), 2, h0, w0, c, jdt)
    with pltpu.force_tpu_interpret_mode():
        ref = _pallas_rcu_nhwc(args, jdt, r)
    ours = _port_rcu(args, tdt)
    assert ours.dtype == tdt and ours.shape == ref.shape == (2, h0, w0, c)
    _assert_close(ours.float().numpy(), ref, dtype, 3e-4, bf16_features=True)


def test_refinenet_pre_widths():
    """The kernel chain takes every C, run at rcu_width's padded width (a
    multiple of 64 at bf16, of 32 at f32), the published widths of vits,
    vitb, vitl and vitg unpadded; the TPU kernel's row plan
    (rcu_pick_block_rows, which only keeps the JAX package on XLA's convs)
    gives up at vitl's C = 256 and vitg's 384 on refinenet1's 1080p grid,
    though the kernel itself takes them (tests/test_torch_rcu_widths.py)."""
    assert [rp.rcu_width(c, torch.bfloat16) for c in (8, 32, 64, 96, 128)] \
        == [64, 64, 64, 128, 128]
    assert [rp.rcu_width(c, torch.float32) for c in (8, 32, 64, 96, 128)] \
        == [32, 32, 64, 96, 128]
    for c in (64, 128, 256, 384):
        assert rp.rcu_width(c, torch.bfloat16) == c
    assert rcu_pick_block_rows(256, 264, jnp.bfloat16) is None
    assert rcu_pick_block_rows(384, 264, jnp.bfloat16) is None
    assert rcu_pick_block_rows(64, 264, jnp.bfloat16) is not None


def test_rcu_then_ext_tail_matches_pallas_chain():
    """refinenet_pre -> head_tail_ext (NHWC between them) against
    refinenet_pre_pallas -> head_tail_ext_pallas(channel_major_halo=True),
    f32 within 1e-3 (tests/test_head_tail.py)."""
    h0, w0, c = 36, 64, 32
    c2, c3 = c // 2, 32
    h1, w1 = h0 * 2 * 14 // 8, w0 * 2 * 14 // 8
    jdt, tdt = jnp.dtype("float32"), torch.float32
    rng = np.random.default_rng(17)
    args = _rcu_args(rng, 2, h0, w0, c, jdt)
    tail = _arrays(rng, [((1, 1, c, c), c ** -0.5, 0.0), ((c,), 0.1, 0.0),
                         ((3, 3, c, c2), (9 * c) ** -0.5, 0.0),
                         ((c2,), 0.1, 0.0),
                         ((3, 3, c2, c3), (9 * c2) ** -0.5, 0.0),
                         ((c3,), 0.1, 0.0), ((1, 1, c3, 1), c3 ** -0.5, 0.0),
                         ((1,), 0.1, 0.5)], jdt)
    with pltpu.force_tpu_interpret_mode():
        pre = refinenet_pre_pallas(*(jnp.asarray(a) for a in args),
                                   block_rows=16, interpret=True)
        ref = np.asarray(head_tail_ext_pallas(
            pre, *(jnp.asarray(a) for a in tail), (h1, w1), block_rows=16,
            channel_major_halo=True, interpret=True))
    ports = [_hwio(a, tdt) if a.ndim == 4 else _t(a, tdt) for a in tail]
    ours = ht.head_tail_ext(_port_rcu(args, tdt), *ports, (h1, w1)).numpy()
    assert ours.shape == ref.shape == (2, h1, w1)
    assert np.abs(ours - ref).max() <= 1e-3
