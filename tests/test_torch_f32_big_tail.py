"""PyTorch port, f32 on the card: the DPT tails at f32 on the CPU. The big-C
tail (rows 11 and 12, ``vrvg_head_tail_big_f32``) and the ext tail (row 7,
``vrvg_head_tail_ext_f32``) at the widths the f32 kernels now take: their
plain versions at f32, which the card holds the kernels against, against
the JAX package's ``head_tail_big_pallas`` and ``head_tail_ext_pallas`` at
f32 in interpret mode within the JAX tests' f32 bound (2e-5), the big-C
tail on grids of 4 and 5 rows (its plan given: the JAX planner wants 8 rows
or more) where the ``cw`` edge rows make up most of the image; out_conv's
mix folded into conv1 in f32 as the JAX front folds it; and the stages
the f32 chain returns composed against the whole plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vr_video_generator_tpu.ops.head_tail_pallas import (head_tail_big_pallas,
                                                         head_tail_ext_pallas)
from vr_video_generator_tpu_torch.ops import head_tail as ht

torch.set_num_threads(2)
torch.set_grad_enabled(False)

F32_ATOL = 2e-5  # the JAX tests' f32 bound


def _weights(rng, c):
    """Seeded f32 tail weights in PyTorch layout: out_conv, its bias, conv1,
    its bias, conv2, its bias, the 1x1, its bias."""
    c2, c3 = c // 2, 32
    shapes = [((c, c, 1, 1), c ** -0.5, 0.0), ((c,), 0.1, 0.0),
              ((c2, c, 3, 3), (9 * c) ** -0.5, 0.0), ((c2,), 0.1, 0.0),
              ((c3, c2, 3, 3), (9 * c2) ** -0.5, 0.0), ((c3,), 0.1, 0.0),
              ((1, c3, 1, 1), c3 ** -0.5, 0.0), ((1,), 0.1, 0.5)]
    return [torch.from_numpy((rng.standard_normal(s) * k + o)
                             .astype(np.float32)) for s, k, o in shapes]


def _jax_args(wts):
    """The weights as the JAX tails take them: convs HWIO, biases as they
    are."""
    return [jnp.asarray(w.numpy().transpose(2, 3, 1, 0)) if w.ndim == 4
            else jnp.asarray(w.numpy()) for w in wts]


@pytest.mark.parametrize("c,h0,w0,plan", [
    (64, 4, 7, (4, 4, 8, 8)), (128, 5, 6, (4, 4, 8, 10)),
    (256, 4, 9, (4, 4, 8, 8)), (128, 8, 11, None)])
def test_big_tail_f32_plain_matches_pallas_interpret(c, h0, w0, plan):
    """Rows 11 and 12 at f32 (vits-728's C = 64, vitb's 128, vitl's 256):
    the wrapper on CPU tensors (the plain versions) against
    head_tail_big_pallas at f32 in interpret mode within 2e-5, the input an
    NCHW activation seen as NHWC as the model hands it over. At 4 and 5
    rows every conv1 row but two or three is a top or bottom edge row, each
    with its own cw."""
    rng = np.random.default_rng(c + h0 * w0)
    b = 2
    out_hw = (h0 * 14 // 4, w0 * 14 // 4)
    x = rng.standard_normal((b, c, h0, w0)).astype(np.float32)
    wts = _weights(rng, c)
    ref = np.asarray(head_tail_big_pallas(
        jnp.asarray(x.transpose(0, 2, 3, 1)), *_jax_args(wts), out_hw,
        plan=plan, interpret=True))
    ours = ht.head_tail_big(torch.from_numpy(x).permute(0, 2, 3, 1), *wts,
                            out_hw)
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    assert (ref > 0).mean() > 0.2
    assert np.abs(ours.numpy() - ref).max() <= F32_ATOL


@pytest.mark.parametrize("c,h0,w0", [(128, 12, 22), (256, 12, 16)])
def test_ext_tail_f32_plain_matches_pallas_interpret(c, h0, w0):
    """Row 7 at f32 at the widths its f32 kernel now takes past vits' 64
    (vitb-252's C = 128, vitl-126's 256) against head_tail_ext_pallas at
    f32 in interpret mode within 2e-5."""
    rng = np.random.default_rng(7 * c + h0)
    out_hw = (h0 * 14 // 4, w0 * 14 // 4)
    x = rng.standard_normal((2, h0, w0, c)).astype(np.float32)
    wts = _weights(rng, c)
    ref = np.asarray(head_tail_ext_pallas(jnp.asarray(x), *_jax_args(wts),
                                          out_hw, interpret=True))
    ours = ht.head_tail_ext(torch.from_numpy(x), *wts, out_hw)
    assert ours.shape == ref.shape and (ref > 0).mean() > 0.2
    assert np.abs(ours.numpy() - ref).max() <= F32_ATOL


def test_f32_widths():
    """Both f32 tails take every width of an encoder's head (64-384) and
    every other width the JAX kernels take (C a multiple of 16; the big-C
    tail C <= 128 or a multiple of 128), zero-padded to the chains' widths
    (multiples of 32: an encoder's head unpadded, C2 = 16 padded to 32)."""
    assert all(ht.takes(c) and ht.takes(c, "big")
               for c in (16, 32, 64, 128, 256, 384))
    assert ht.takes(160) and not ht.takes(160, "big")
    assert not ht.takes(40) and not ht.takes(40, "big")
    f32 = torch.float32
    assert [ht.chain_widths(c, f32) for c in (32, 64, 128, 256, 384)] == \
        [(32, 32), (64, 32), (128, 64), (256, 128), (384, 192)]
    assert [ht.chain_widths(c, f32) for c in (16, 48, 80, 144, 512)] == \
        [(32, 32), (64, 32), (96, 64), (160, 96), (512, 256)]


@pytest.mark.parametrize("c", [128, 384])
def test_fold_conv1_f32_matches_jax_fold(c):
    """out_conv's 1x1 mix folded into conv1's weights in f32 (the f32 big
    tail's conv1 operand) against the JAX front's fold (einsum of the two
    f32 kernels, head_tail_pallas.py:710) within 2 f32 ulps of the
    weights' scale; and fold_conv1 at f32 casts nothing."""
    rng = np.random.default_rng(c)
    k_oc, _, k1 = _weights(rng, c)[:3]
    ours = ht.fold_conv1(k_oc, k1, torch.float32)
    ref = np.asarray(jnp.einsum("ij,hwjo->hwio",
                                jnp.asarray(k_oc.numpy()[:, :, 0, 0].T),
                                jnp.asarray(k1.numpy().transpose(2, 3, 1, 0))))
    ref = ref.transpose(3, 2, 0, 1)
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    ulp = np.spacing(np.float32(np.abs(ref).max()))
    assert np.abs(ours.numpy() - ref).max() <= 2 * ulp


@pytest.mark.parametrize("c", [64, 256])
def test_big_tail_f32_stages_compose_to_whole_plain(c):
    """head_tail_big_stages on CPU tensors: (U, mid, R, depth), the plain
    stages of rows 11 and 12, which compose to head_tail_big_plain bit for
    bit; the big tail's wrapper returns the same depth."""
    rng = np.random.default_rng(c + 1)
    h0, w0 = 5, 8
    out_hw = (17, 28)
    x = torch.from_numpy(rng.standard_normal((2, h0, w0, c))
                         .astype(np.float32))
    wts = _weights(rng, c)
    k_oc, b_oc, k1, b1, k2, b2, k3, b3 = wts
    u, mid, r, depth = ht.head_tail_big_stages(x, *wts, out_hw)
    assert torch.equal(u, ht.big_upsample_plain(x))
    assert torch.equal(mid, ht.big_conv1_plain(u, k_oc, k1))
    assert torch.equal(r, ht.big_resize_plain(mid, k1, b_oc, b1, out_hw))
    assert torch.equal(depth, ht.big_conv2_plain(r, k2, b2, k3, b3))
    assert u.shape == (2, 2 * h0, 2 * w0, c) and mid.shape[-1] == c // 2
    assert r.shape == (2, *out_hw, c // 2)
    assert all(t.dtype == torch.float32 for t in (u, mid, r, depth))
    assert torch.equal(depth, ht.head_tail_big_plain(x, *wts, out_hw))
    assert torch.equal(depth, ht.head_tail_big(x, *wts, out_hw))
