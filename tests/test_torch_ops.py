"""PyTorch port, ops: host tables and each kernel module's plain version
against the JAX package (Pallas kernels in interpret mode), on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_warp import synth_depth, synth_img
from vr_video_generator_tpu.ops import gaussian as jgauss
from vr_video_generator_tpu.ops import resize as jresize
from vr_video_generator_tpu.ops.attention_pallas import oneshot_mha
from vr_video_generator_tpu.ops.gelu import gelu_exact as jgelu
from vr_video_generator_tpu.ops.layernorm import layernorm as jlayernorm
from vr_video_generator_tpu.ops.preprocess import (network_input_size as
                                                   jnet_size,
                                                   preprocess_frames as
                                                   jpreprocess)
from vr_video_generator_tpu.ops.warp import WarpSpec as JWarpSpec
from vr_video_generator_tpu.utils.config import StereoConfig
from vr_video_generator_tpu_torch.ops import resize
from vr_video_generator_tpu_torch.ops.attention import attention, mha
from vr_video_generator_tpu_torch.ops.gaussian import gaussian_kernel1d
from vr_video_generator_tpu_torch.ops.gelu import gelu_exact
from vr_video_generator_tpu_torch.ops.layernorm import layernorm
from vr_video_generator_tpu_torch.ops.preprocess import (network_input_size,
                                                         preprocess_frames)
from vr_video_generator_tpu_torch.ops.warp import WarpSpec

torch.set_num_threads(2)


@pytest.mark.parametrize("name,args", [
    ("area_weights", (1080, 518)), ("area_weights", (1920, 924)),
    ("area_zoom_weights", (48, 56)), ("area_or_linear_weights", (64, 98, True)),
    ("linear_weights", (37, 74, True)), ("linear_weights", (10, 7, False, 0.8)),
    ("cubic_weights", (518, 1080, True)), ("cubic_weights", (37, 66, False, 66.1 / 37)),
])
def test_resize_matrices_array_equal(name, args):
    np.testing.assert_array_equal(getattr(resize, name)(*args),
                                  getattr(jresize, name)(*args))


@pytest.mark.parametrize("ksize,sigma", [(11, 3.0), (9, 3.0), (3, 3.0), (19, 3.0)])
def test_gaussian_kernel_array_equal(ksize, sigma):
    np.testing.assert_array_equal(gaussian_kernel1d(ksize, sigma),
                                  jgauss.gaussian_kernel1d(ksize, sigma))


def test_network_input_size_1080p():
    assert network_input_size(1080, 1920) == (518, 924)
    for hw in ((48, 64), (720, 1280), (2160, 3840), (1440, 1080)):
        assert network_input_size(*hw, target=56) == jnet_size(*hw, target=56)
        assert network_input_size(*hw) == jnet_size(*hw)


def test_warp_spec_sizing():
    spec = WarpSpec.create(1080, 1920, StereoConfig())
    assert (spec.s_neg, spec.s_pos, spec.kernel_size) == (20, 48, 4)
    # includes heights where 0.0036*H rounds half to even
    for h, fg, step in ((1080, 0.025, 1), (2160, 0.025, 1), (139, 0.03, 2),
                        (417, 0.01, 3), (48, 0.025, 1), (720, 0.04, 1)):
        cfg = StereoConfig(offset_fg=fg, offset_step_size=step)
        ours, ref = WarpSpec.create(h, 64, cfg), JWarpSpec.create(h, 64, cfg)
        assert (ours.s_neg, ours.s_pos, ours.kernel_size, ours.max_planes) == \
            (ref.s_neg, ref.s_pos, ref.kernel_size, ref.max_planes)


def test_resize_appliers_match_jax(rng):
    x = rng.random((2, 48, 64, 3)).astype(np.float32)
    pairs = [
        (resize.resize_area_cv2(torch.from_numpy(x), (30, 40)),
         jresize.resize_area_cv2(jnp.asarray(x), (30, 40))),
        (resize.resize_bilinear(torch.from_numpy(x), (96, 100)),
         jresize.resize_bilinear(jnp.asarray(x), (96, 100))),
        (resize.resize_bicubic(torch.from_numpy(x), (7, 9), align_corners=False,
                               scale_hw=(7.1 / 48, 9.1 / 64)),
         jresize.resize_bicubic(jnp.asarray(x), (7, 9), align_corners=False,
                                scale_hw=(7.1 / 48, 9.1 / 64))),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_preprocess_exact_matches_jax(rng):
    frames = rng.integers(0, 256, (2, 48, 80, 3), dtype=np.uint8)
    net = network_input_size(48, 80, target=56)
    ours = preprocess_frames(torch.from_numpy(frames), net).numpy()
    ref = np.asarray(jpreprocess(jnp.asarray(frames), net, impl="exact"))
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_gelu_matches_jax(rng):
    x = np.concatenate([rng.standard_normal(5000).astype(np.float32) * 4,
                        np.linspace(-9, 9, 1001, dtype=np.float32)])
    ours = gelu_exact(torch.from_numpy(x)).numpy()
    ref = np.asarray(jgelu(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rows", [300, 130])
def test_layernorm_plain_matches_pallas_interpret(rows):
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, 128), dtype=np.float32) * 3 + 1
    w = rng.standard_normal(128, dtype=np.float32)
    b = rng.standard_normal(128, dtype=np.float32)
    ref = np.asarray(jlayernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                interpret=True, block_rows=64))
    ours = layernorm(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,n,h", [(2, 321, 2), (1, 512, 2), (1, 70, 1)])
def test_mha_plain_matches_oneshot_interpret(b, n, h):
    """N = 321 and 70 are not multiples of the Pallas kernel's q block."""
    rng = np.random.default_rng(n)
    q, k, v = (rng.standard_normal((b, n, h, 64)).astype(np.float32)
               for _ in range(3))
    scale = 64 ** -0.5
    ref = np.asarray(oneshot_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 scale, block_q=256, interpret=True))
    ours = mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
               scale).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-5)


def test_attention_accepts_strided_qkv_views(rng):
    """k and v arrive as views into the fused qkv projection."""
    qkv = torch.from_numpy(rng.standard_normal((2, 33, 3, 2, 64),
                                               dtype=np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    np.testing.assert_array_equal(
        attention(q, k, v).numpy(),
        attention(q.contiguous(), k.contiguous(), v.contiguous()).numpy())


def test_kernel_wrappers_refuse_mixed_devices():
    x = torch.zeros(4, 128)
    with pytest.raises(ValueError, match="devices"):
        layernorm(x, torch.ones(128, device="meta"), torch.zeros(128))


def _warp_inputs(h, w):
    """Three frames: depth up to 5, up to 14, and up to 30 (above the
    limit_step_cap of 24, so the tables saturate); ranges are each frame's
    own un-smoothed offset range."""
    rng = np.random.default_rng(h * 1000 + w)
    imgs = np.stack([synth_img(rng, h, w) for _ in range(3)])
    depths = np.stack([synth_depth(rng, h, w, tmax=t) for t in (5.0, 14.0, 30.0)])
    jspec = JWarpSpec.create(h, w, StereoConfig(), impl="pallas")
    ranges = np.stack([np.asarray(jspec.frame_offset_range(jnp.asarray(d)))
                       for d in depths])
    return imgs, depths, ranges, jspec


@pytest.mark.parametrize("h,w", [(150, 96), (61, 97)])
def test_warp_batch_bit_exact_vs_pallas_interpret(h, w):
    """Composite, covered and SBS bit-exact against warp_batch_pallas in
    interpret mode: circular wrap at both edges, the zip truncation, the 3/5
    fill index, the edge width, round-half-even tables and blur, depth above
    the cap; 150 rows give a blur window of (5, 3), 61 rows of (3, 1)."""
    imgs, depths, ranges, jspec = _warp_inputs(h, w)
    ref = np.asarray(jspec.warp_batch(jnp.asarray(imgs), jnp.asarray(depths),
                                      jnp.asarray(ranges), interpret=True))
    spec = WarpSpec.create(h, w, StereoConfig())
    ours = spec.warp_batch(torch.from_numpy(imgs), torch.from_numpy(depths),
                           torch.from_numpy(ranges)).numpy()
    np.testing.assert_array_equal(ours, ref)


def test_composite_and_covered_bit_exact_vs_pallas_interpret():
    from vr_video_generator_tpu.ops.warp import (build_plane_tables as
                                                 jplane, build_shift_tables as
                                                 jshift)
    from vr_video_generator_tpu.ops.warp_pallas import warp_composite_pallas
    from vr_video_generator_tpu_torch.ops.warp import warp_composite

    h, w = 72, 128
    imgs, depths, ranges, jspec = _warp_inputs(h, w)
    spec = WarpSpec.create(h, w, StereoConfig())
    _, st = spec.tables(torch.from_numpy(depths), torch.from_numpy(ranges))
    comp, cov = warp_composite(torch.from_numpy(imgs), torch.from_numpy(depths),
                               st, spec.s_neg, spec.s_pos)
    for i in range(len(imgs)):
        jst = jshift(jplane(jnp.asarray(depths[i]), jnp.asarray(ranges[i]),
                            jspec.cfg, h, jspec.max_planes),
                     jspec.s_neg, jspec.s_pos)
        np.testing.assert_array_equal(st.lo[i].numpy(), np.asarray(jst.lo))
        np.testing.assert_array_equal(st.hi[i].numpy(), np.asarray(jst.hi))
        np.testing.assert_array_equal(st.valid[i].numpy(), np.asarray(jst.valid))
        assert int(st.fill_offset[i]) == int(jst.fill_offset)
        assert int(st.edge_width[i]) == int(jst.edge_width)
        rcomp, rcov = warp_composite_pallas(jnp.asarray(imgs[i]),
                                            jnp.asarray(depths[i]), jst,
                                            jspec.s_neg, jspec.s_pos,
                                            interpret=True)
        np.testing.assert_array_equal(comp[i].numpy(), np.asarray(rcomp))
        np.testing.assert_array_equal(cov[i].numpy(), np.asarray(rcov))
