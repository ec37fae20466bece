"""PyTorch port, f32 on the card: the plain versions the f32 kernels are held
against on the card, at f32, against the JAX package's Pallas functions at
f32 in interpret mode, where the older tests leave a row uncovered: row 5
at vits' D = 384, row 17 through the JAX library flash kernel, row 2 at
vits' six heads on strided q/k/v views, and row 7 at vits' C = 64 on a
vits-shaped grid through the whole ``head_tail_ext`` wrapper."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vr_video_generator_tpu.ops.attention import _flash_mha
from vr_video_generator_tpu.ops.attention_pallas import oneshot_mha
from vr_video_generator_tpu.ops.head_tail_pallas import head_tail_ext_pallas
from vr_video_generator_tpu.ops.qkv_pallas import ln_qkv_pallas
from vr_video_generator_tpu_torch.ops.attention import flash_attention, mha
from vr_video_generator_tpu_torch.ops.head_tail import head_tail_ext
from vr_video_generator_tpu_torch.ops.qkv import ln_qkv

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("b,n", [(2, 45), (1, 130)])
def test_ln_qkv_plain_at_d384_matches_pallas_interpret_f32(b, n):
    """Row 5 at vits' D = 384 (6 heads), f32, against ln_qkv_pallas in
    interpret mode within 2e-5 (f32 sums in another order; the JAX tests'
    f32 bound for the half-block); N not a multiple of its token block."""
    d, heads = 384, 6
    rng = np.random.default_rng(n)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    lnw = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    lnb = (0.1 * rng.standard_normal(d)).astype(np.float32)
    w = (rng.standard_normal((3 * d, d)) / np.sqrt(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(3 * d)).astype(np.float32)
    qt, kt, vt = ln_qkv_pallas(jnp.asarray(x), jnp.asarray(lnw),
                               jnp.asarray(lnb), jnp.asarray(w.T),
                               jnp.asarray(bias), heads, 64 ** -0.5,
                               interpret=True)
    ref = np.stack([np.asarray(t)[:, :, :n].transpose(0, 2, 1, 3)
                    for t in (qt, kt, vt)], axis=2)
    ours = ln_qkv(_t(x), _t(lnw), _t(lnb), _t(w), _t(bias), heads,
                  64 ** -0.5)
    assert ours.dtype == torch.float32 and ours.shape == (b, n, 3, heads, 64)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=2e-5)


def test_flash_attention_plain_f32_matches_library_kernel():
    """Row 17 at f32: (B, N, H, D) = (1, 4200, 1, 64), scale 0.125, against
    the JAX package's _flash_mha (the library kernel in TPU interpret mode,
    512-key blocks past 4096 keys). Nothing is cast at f32, so the two agree
    to f32 rounding: within 2e-6 of max |o|."""
    rng = np.random.default_rng(1)
    b, n, h, d = 1, 4200, 1, 64
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32)
               for _ in range(3))
    k *= 1.5
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_flash_mha(*(jnp.asarray(a) for a in (q, k, v)),
                                    0.125))
    ours = flash_attention(_t(q), _t(k), _t(v), 0.125)
    assert ours.dtype == torch.float32 and ours.shape == (b, n, h, d)
    err = np.abs(ours.numpy() - ref).max()
    assert err <= 2e-6 * np.abs(ref).max()


def test_mha_plain_f32_at_six_heads_on_qkv_views():
    """Row 2 at f32 at vits' six heads, q, k and v strided views into one
    (B, N, 3, H, 64) qkv as the fused half hands them over, against
    oneshot_mha in interpret mode within 2e-5."""
    rng = np.random.default_rng(6)
    b, n, h = 2, 97, 6
    qkv = rng.standard_normal((b, n, 3, h, 64)).astype(np.float32)
    scale = 64 ** -0.5
    ref = np.asarray(oneshot_mha(*(jnp.asarray(qkv[:, :, i])
                                   for i in range(3)),
                                 scale, block_q=256, interpret=True))
    t = _t(qkv)
    ours = mha(t[:, :, 0], t[:, :, 1], t[:, :, 2], scale)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=2e-5)


def test_head_tail_ext_f32_at_c64_on_a_vits_grid():
    """Row 7 at f32, C = 64, on a 12 x 22 grid (about the aspect of vits'
    148 x 264 at 1080p) with the depth at 42 x 77, against head_tail_ext_pallas
    in interpret mode within 5e-4 (the JAX test's bound), the input handed
    over as the model does: an NCHW activation seen as NHWC."""
    rng = np.random.default_rng(64)
    c, c2, c3 = 64, 32, 32
    h0, w0, out_hw = 12, 22, (42, 77)
    x = rng.standard_normal((2, c, h0, w0)).astype(np.float32)
    hwio = [(rng.standard_normal(s) * k).astype(np.float32) for s, k in (
        ((1, 1, c, c), c ** -0.5), ((c,), 0.1), ((3, 3, c, c2), (9 * c) ** -0.5),
        ((c2,), 0.1), ((3, 3, c2, c3), (9 * c2) ** -0.5), ((c3,), 0.1),
        ((1, 1, c3, 1), c3 ** -0.5), ((1,), 0.1))]
    hwio[-1] += 0.5
    ref = np.asarray(head_tail_ext_pallas(
        jnp.asarray(x.transpose(0, 2, 3, 1)),
        *(jnp.asarray(a) for a in hwio), out_hw, interpret=True))
    oihw = [_t(a.transpose(3, 2, 0, 1)) if a.ndim == 4 else _t(a)
            for a in hwio]
    ours = head_tail_ext(_t(x).permute(0, 2, 3, 1), *oihw, out_hw)
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    assert (ref > 0).mean() > 0.2
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=5e-4)
