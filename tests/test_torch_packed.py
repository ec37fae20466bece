"""PyTorch port, slice 5 on the CPU: the packed SBS output path. The packed
blur/select (row 13) and the banded compositor (row 14) plain versions
against the JAX package's Pallas kernels in interpret mode; ``warp_impl``
and the packed emit as the JAX WarpSpec resolves them; the packed pipeline
against the JAX SbsPipeline; packed frames through process_segment and the
writer; and the pinned readback buffers' dtype."""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_ops import _warp_inputs
from tests.test_torch_pipeline import BATCH, CFG, TINY, H, W, _Reader, _Writer
from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.depth_anything_v2 import (
    DepthAnythingV2 as JaxDepthAnythingV2)
from vr_video_generator_tpu.ops.warp import WarpSpec as JWarpSpec
from vr_video_generator_tpu.ops.warp import build_plane_tables as jplane
from vr_video_generator_tpu.ops.warp import build_shift_tables as jshift
from vr_video_generator_tpu.ops.warp_pallas import (
    banded_compositor_fits as jax_banded_fits, blur_select_sbs_pallas,
    warp_composite_pallas)
from vr_video_generator_tpu.pipeline import SbsPipeline as JaxSbsPipeline
from vr_video_generator_tpu.utils.config import StereoConfig as JStereoConfig
from vr_video_generator_tpu_torch import StereoConfig
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.native import unpack_sbs_np
from vr_video_generator_tpu_torch.ops import warp as warp_mod
from vr_video_generator_tpu_torch.ops.warp import (
    UNMATCHED, WarpSpec, band_codes, banded_compositor_fits, blur_select_sbs,
    blur_select_sbs_packed_plain, blur_select_sbs_plain, warp_composite,
    warp_composite_banded_plain, warp_composite_plain)
from vr_video_generator_tpu_torch.pipeline import SbsPipeline
from vr_video_generator_tpu_torch.runtime.segment import (HostStaging,
                                                          process_segment)
from vr_video_generator_tpu_torch.video.writer import SubclipWriter

torch.set_num_threads(2)

PACKED = dataclasses.replace(CFG, sbs_output="packed", warp_impl="pallas")


def _pack(rgb: np.ndarray) -> np.ndarray:
    v = rgb.astype(np.uint32)
    return v[..., 0] | (v[..., 1] << 8) | (v[..., 2] << 16)


@pytest.fixture(scope="module")
def weights():
    return random_state_dict(TINY, seed=2)


@pytest.fixture(scope="module")
def model(weights):
    return build_model(TINY, weights, torch.float32, "cpu")


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(11).integers(0, 256, (3 * BATCH, H, W, 3),
                                              dtype=np.uint8)


# --- row 13: the packed blur/select -----------------------------------------

# 150 rows give a blur window of (5, 3), 61 rows of (3, 1); 97 columns are
# no multiple of the TPU kernel's 128 lanes.
@pytest.mark.parametrize("h,w", [(150, 96), (61, 97)])
def test_blur_select_packed_plain_matches_pallas(h, w):
    """blur_select_sbs_packed_plain against blur_select_sbs_pallas
    (interpret mode), bit for bit: covered pixels keep the composite, holes
    take the blur, x < edge_width the original, the right half the
    original, the top byte zero. The CPU wrapper with emit="packed" is the
    plain version."""
    rng = np.random.default_rng(h * 100 + w)
    b = 3
    comp = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    orig = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    covered = rng.random((b, h, w)) < 0.7
    edge = np.array([5, 0, w // 3], np.int32)
    spec = WarpSpec.create(h, w, StereoConfig())
    ks, sigma = spec.kernel_size, spec.cfg.sigma
    ref = np.asarray(blur_select_sbs_pallas(
        jnp.asarray(_pack(comp)), jnp.asarray(covered),
        jnp.asarray(_pack(orig)), jnp.asarray(edge), ks, sigma,
        interpret=True))
    args = (torch.from_numpy(comp), torch.from_numpy(covered),
            torch.from_numpy(orig), torch.from_numpy(edge), ks, sigma)
    ours = blur_select_sbs_packed_plain(*args)
    assert ours.dtype == torch.uint32 and tuple(ours.shape) == (b, h, 2 * w)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert not np.any(ours.numpy() >> 24)
    np.testing.assert_array_equal(blur_select_sbs(*args, emit="packed").numpy(),
                                  ref)
    np.testing.assert_array_equal(unpack_sbs_np(ref),
                                  blur_select_sbs_plain(*args).numpy())


@pytest.mark.parametrize("h,w", [(150, 96), (61, 97)])
def test_warp_batch_packed_matches_pallas(h, w):
    """WarpSpec(impl="pallas").warp_batch(emit="packed") against the JAX
    WarpSpec's warp_batch_pallas(emit="packed", interpret=True), bit for
    bit; it unpacks to the u8 emit."""
    imgs, depths, ranges, jspec = _warp_inputs(h, w)
    ref = np.asarray(jspec.warp_batch(jnp.asarray(imgs), jnp.asarray(depths),
                                      jnp.asarray(ranges), emit="packed",
                                      interpret=True))
    spec = WarpSpec.create(h, w, StereoConfig(), impl="pallas")
    args = (torch.from_numpy(imgs), torch.from_numpy(depths),
            torch.from_numpy(ranges))
    ours = spec.warp_batch(*args, emit="packed")
    assert ours.dtype == torch.uint32 and tuple(ours.shape) == (3, h, 2 * w)
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(unpack_sbs_np(ours.numpy()),
                                  spec.warp_batch(*args).numpy())


# --- repair: warp_impl and the emit -----------------------------------------

def test_warp_impl_resolves_as_jax():
    """auto -> xla off the card (as the JAX WarpSpec on the CPU backend) and
    pallas on CUDA; an unknown impl raises; packed with a resolved xla
    raises the JAX package's ValueError."""
    h, w = 61, 97
    for impl in ("auto", "xla", "pallas"):
        want = JWarpSpec.create(h, w, JStereoConfig(), impl=impl).impl
        assert WarpSpec.create(h, w, StereoConfig(), impl=impl).impl == want
    assert WarpSpec.create(h, w, StereoConfig(), impl="auto",
                           device="cuda").impl == "pallas"
    with pytest.raises(ValueError, match="warp_impl"):
        WarpSpec.create(h, w, StereoConfig(), impl="triton")
    imgs, depths, ranges, jspec = _warp_inputs(h, w)
    msg = "packed SBS output requires the pallas warp"
    with pytest.raises(ValueError, match=msg):
        JWarpSpec.create(h, w, JStereoConfig(), impl="xla").warp_batch(
            jnp.asarray(imgs), jnp.asarray(depths), jnp.asarray(ranges),
            emit="packed")
    with pytest.raises(ValueError, match=msg):
        WarpSpec.create(h, w, StereoConfig(), impl="xla").warp_batch(
            torch.from_numpy(imgs), torch.from_numpy(depths),
            torch.from_numpy(ranges), emit="packed")


@pytest.mark.parametrize("impl,kernel_route", [("xla", False),
                                               ("pallas", True),
                                               ("auto", False)])
def test_warp_impl_selects_the_route(model, frames, monkeypatch, impl,
                                     kernel_route):
    """The pipeline honours --warp_impl: "pallas" goes through the kernel
    wrappers (their plain versions for CPU tensors), "xla" (and "auto" off
    the card) through the plain composite and blur/select; both give the
    same SBS. Packed output with a resolved xla raises at the first step."""
    calls = []

    def spy(fn):
        def wrapped(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(warp_mod, "warp_composite", spy(warp_composite))
    monkeypatch.setattr(warp_mod, "blur_select_sbs", spy(blur_select_sbs))
    pipe = SbsPipeline(model, H, W, run_cfg=dataclasses.replace(
        CFG, warp_impl=impl))
    assert pipe.spec.impl == ("pallas" if kernel_route else "xla")
    sbs, _ = pipe.step(frames[:BATCH], pipe.initial_state())
    assert calls == (["warp_composite", "blur_select_sbs"] if kernel_route
                     else [])
    plain = SbsPipeline(model, H, W, run_cfg=dataclasses.replace(
        CFG, warp_impl="xla"))
    np.testing.assert_array_equal(
        sbs.numpy(), plain.step(frames[:BATCH], plain.initial_state())[0].numpy())
    packed = SbsPipeline(model, H, W, run_cfg=dataclasses.replace(
        CFG, warp_impl=impl, sbs_output="packed"))
    assert packed.sbs_emit == "packed"
    if kernel_route:
        out, _ = packed.step(frames[:BATCH], packed.initial_state())
        np.testing.assert_array_equal(unpack_sbs_np(out.numpy()), sbs.numpy())
    else:
        with pytest.raises(ValueError, match="requires the pallas warp"):
            packed.step(frames[:BATCH], packed.initial_state())


# --- row 14: the banded compositor ------------------------------------------

@pytest.mark.parametrize("case", ["smooth", "unmatched"])
def test_banded_plain_matches_pallas_and_classic(case):
    """warp_composite_banded_plain against warp_composite_pallas(banded=True,
    interpret=True) per frame and against the classic plain version, bit for
    bit. The smooth depth crosses many 5%-overlap band edges (the dual-band
    code); "unmatched" puts depths above every band, which must take code
    254 and hole-fill rather than be claimed by the rank-0 shift."""
    h, w = 72, 128
    imgs, table_depths, ranges, jspec = _warp_inputs(h, w)
    spec = WarpSpec.create(h, w, StereoConfig())
    _, st = spec.tables(torch.from_numpy(table_depths),
                        torch.from_numpy(ranges))
    depths = table_depths.copy()
    if case == "unmatched":  # after the tables, as the JAX test does
        depths[1, 3, 5:9] = 1e6
        depths[2, 40, :7] = 1e6
    d = torch.from_numpy(depths)
    img = torch.from_numpy(imgs)
    comp, cov = warp_composite_banded_plain(img, d, st, spec.s_neg, spec.s_pos)
    comp_c, cov_c = warp_composite_plain(img, d, st, spec.s_neg, spec.s_pos)
    np.testing.assert_array_equal(comp.numpy(), comp_c.numpy())
    np.testing.assert_array_equal(cov.numpy(), cov_c.numpy())
    for got, want in zip(warp_composite(img, d, st, spec.s_neg, spec.s_pos,
                                        banded=True), (comp, cov)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    code = band_codes(d, st)
    assert bool(((code >= 128) & (code < UNMATCHED)).any())  # dual bands
    if case == "unmatched":
        assert bool((code[1, 3, 5:9] == UNMATCHED).all())
        assert bool((code[2, 40, :7] == UNMATCHED).all())
    for i in range(len(imgs)):
        jst = jshift(jplane(jnp.asarray(table_depths[i]),
                            jnp.asarray(ranges[i]), jspec.cfg, h,
                            jspec.max_planes), jspec.s_neg, jspec.s_pos)
        rcomp, rcov = warp_composite_pallas(
            jnp.asarray(imgs[i]), jnp.asarray(depths[i]), jst, jspec.s_neg,
            jspec.s_pos, interpret=True, banded=True)
        np.testing.assert_array_equal(comp[i].numpy(), np.asarray(rcomp))
        np.testing.assert_array_equal(cov[i].numpy(), np.asarray(rcov))


def test_banded_falls_back_past_126_shifts():
    """The 7-bit rank covers 126 shifts, as banded_compositor_fits says in
    both packages (4K's cap-sized table has 134): warp_composite(banded=True)
    there runs the classic compositor, and the banded plain version
    refuses."""
    for h in (480, 720, 1080, 1440, 2160):
        s = WarpSpec.create(h, 64, StereoConfig())
        js = JWarpSpec.create(h, 64, JStereoConfig())
        assert banded_compositor_fits(s.s_neg, s.s_pos) \
            == jax_banded_fits(js.s_neg, js.s_pos) == (h < 2160)
    h, w = 2160, 64
    spec = WarpSpec.create(h, w, StereoConfig())
    assert spec.s_neg + spec.s_pos + 1 == 134
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8))
    d = torch.from_numpy(np.clip(
        np.linspace(0, 14, w, dtype=np.float32)[None, None]
        + rng.normal(0, 0.4, (1, h, w)).astype(np.float32), 0, None))
    ls = torch.ceil(d.amax(dim=(1, 2)))
    ranges = torch.stack([spec.cfg.offset_bg * h * ls / 14.0,
                          spec.cfg.offset_fg * h * ls / 14.0], dim=1)
    _, st = spec.tables(d, ranges)
    comp, cov = warp_composite(img, d, st, spec.s_neg, spec.s_pos, banded=True)
    comp_c, cov_c = warp_composite_plain(img, d, st, spec.s_neg, spec.s_pos)
    assert torch.equal(comp, comp_c) and torch.equal(cov, cov_c)
    assert 0.0 < float(cov.float().mean()) < 1.0
    with pytest.raises(ValueError, match="126 shifts"):
        warp_composite_banded_plain(img, d, st, spec.s_neg, spec.s_pos)


# --- the slice: the packed pipeline -----------------------------------------

def test_packed_pipeline_matches_jax(model, weights, frames):
    """SbsPipeline(sbs_output="packed", warp_impl="pallas") against the JAX
    SbsPipeline with the same options (its Pallas kernels in TPU interpret
    mode), three batches with carried state: uint32 (B, H, 2W) words, the
    right half bit-equal, >= 99.9% of left-half words equal (an f32 ulp of
    depth can move a pixel across a band edge, as in
    test_slice_matches_jax_pipeline), and the words unpack to the port's
    own u8 output bit for bit."""
    import jax

    jmodel = JaxDepthAnythingV2(TINY, dtype=jnp.float32, tail="xla")
    jparams = jax.tree.map(jnp.asarray, convert_state_dict(weights, TINY))
    jpipe = JaxSbsPipeline(jmodel, jparams, H, W, run_cfg=PACKED)
    assert jpipe.sbs_emit == "packed"
    pipe = SbsPipeline(model, H, W, run_cfg=PACKED)
    u8 = SbsPipeline(model, H, W, run_cfg=dataclasses.replace(
        CFG, warp_impl="pallas"))
    assert (pipe.spec.impl, pipe.sbs_emit) == ("pallas", "packed")
    jstate, state, ustate = (jpipe.initial_state(), pipe.initial_state(),
                             u8.initial_state())
    with pltpu.force_tpu_interpret_mode():
        for i in range(3):
            batch = frames[i * BATCH:(i + 1) * BATCH]
            jsbs, jstate = jpipe.step(batch, jstate)
            sbs, state = pipe.step(batch, state)
            sbs_u8, ustate = u8.step(batch, ustate)
            ref, ours, sbs_u8 = np.asarray(jsbs), sbs.numpy(), sbs_u8.numpy()
            assert ours.dtype == ref.dtype == np.uint32
            assert ours.shape == ref.shape == (BATCH, H, 2 * W)
            np.testing.assert_array_equal(ours[:, :, W:], _pack(batch))
            np.testing.assert_array_equal(ref[:, :, W:], _pack(batch))
            assert np.mean(ours[:, :, :W] != _pack(batch)) > 0.5
            same = np.mean(ours[:, :, :W] == ref[:, :, :W])
            assert same >= 0.999, f"batch {i}: {same:.5f} of left words equal"
            np.testing.assert_array_equal(unpack_sbs_np(ours), sbs_u8)


# A stand-in encoder: the writer pipes rgb24 frames to it, and it stores
# the bytes it is given in the subclip's file.
DUMP = [sys.executable, "-c",
        "import shutil, sys; "
        "shutil.copyfileobj(sys.stdin.buffer, open(sys.argv[1], 'wb'))"]


def _raw_clips(directory):
    import os

    clips = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            clips[name] = np.frombuffer(f.read(), np.uint8).reshape(
                -1, H, 2 * W, 3)
    return clips


def test_packed_frames_through_segment_and_writer(model, frames, tmp_path):
    """process_segment with the packed pipeline hands the writer uint32 (H,
    2W) frames, and the writer's rgb24 unpack feeds the encoder exactly the
    bytes of the u8 pipeline's run, clip for clip; the right half is the
    input."""
    n = 10
    collect = _Writer()
    pk = SbsPipeline(model, H, W, run_cfg=PACKED)
    assert process_segment(pk, _Reader(frames[:n]), collect, 0, n,
                           max_frame_count=6, batch_size=BATCH) == n
    assert all(c.dtype == np.uint32 and c.shape[1:] == (H, 2 * W)
               for _, c in collect.clips)
    clips = {}
    for tag, cfg in (("u8", dataclasses.replace(CFG, warp_impl="pallas")),
                     ("packed", PACKED)):
        pipe = SbsPipeline(model, H, W, run_cfg=cfg)
        writer = SubclipWriter(str(tmp_path / tag), fps=10, width=2 * W,
                               height=H, ffmpeg_config=DUMP, backend="ffmpeg")
        assert process_segment(pipe, _Reader(frames[:n]), writer, 0, n,
                               max_frame_count=6, batch_size=BATCH) == n
        writer.close()
        clips[tag] = _raw_clips(tmp_path / tag)
    assert list(clips["packed"]) == ["0_5.mp4", "6_9.mp4"]
    for name, raw in clips["packed"].items():
        np.testing.assert_array_equal(raw, clips["u8"][name])
    out = np.concatenate(list(clips["packed"].values()))
    np.testing.assert_array_equal(out[:, :, W:], frames[:n])
    np.testing.assert_array_equal(
        out, unpack_sbs_np(np.concatenate([c for _, c in collect.clips])))


# --- repair: pinned readback buffers take the tensor's dtype ----------------

def test_host_staging_slots_key_on_shape_and_dtype():
    """A readback slot is allocated in the tensor's own dtype and anew when
    the dtype changes at the same shape (a uint32 SBS batch copied into a
    uint8 buffer would lose every word's upper bytes). On the CPU the
    staging passes a packed batch through."""
    staging = HostStaging(torch.device("cpu"))
    shape = (2, 4, 6)
    k0 = staging._slot("down", shape, torch.uint32)
    assert staging._bufs[k0].dtype == torch.uint32
    assert tuple(staging._bufs[k0].shape) == shape
    k1 = staging._slot("down", shape, torch.uint32)
    assert k1 != k0 and staging._bufs[k1].dtype == torch.uint32
    buf = staging._bufs[k1]
    assert staging._slot("down", shape, torch.uint8) == k0
    assert staging._bufs[k0].dtype == torch.uint8
    assert staging._slot("down", shape, torch.uint32) == k1
    assert staging._bufs[k1] is buf  # same shape and dtype: reused
    words = torch.tensor([[0x00FFFFFF, 0x00010203]], dtype=torch.int32).view(
        torch.uint32)
    back = staging.finish_readback(staging.start_readback(words))
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, [[0x00FFFFFF, 0x00010203]])
