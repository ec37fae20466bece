"""PyTorch port: the depth stride (--depth_stride), the stride audit
(--stride_audit_every) and the adaptive stride (--stride_max_rms,
--stride_hold) on the CPU, against the JAX package on the same converted
weights and seeded inputs, and against the contracts of
tests/test_depth_stride.py.

Bit for bit against JAX: the anchors, and everything after the lerp (the
blended depth, the ranges, the SBS) given the same interpolated depth. The
lerp itself at strides whose weights are not 0.5 and 1 (s = 4) may differ
by one f32 ulp: XLA's CPU backend contracts ``prev * (1 - w) + anchor * w``
into one fused multiply-add, and PyTorch rounds the two products apart.
The audit's rms/max match to rtol 1e-5 on the same depth (the reductions
run in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.depth_anything_v2 import (
    DepthAnythingV2 as JaxDepthAnythingV2)
from vr_video_generator_tpu.ops import temporal as jax_temporal
from vr_video_generator_tpu.pipeline import SbsPipeline as JaxSbsPipeline
from vr_video_generator_tpu.utils.config import ModelConfig, RunConfig
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.ops.temporal import (TemporalState,
                                                       stride_audit_stats,
                                                       stride_interpolate,
                                                       temporal_scan)
from vr_video_generator_tpu_torch.pipeline import SbsPipeline
from vr_video_generator_tpu_torch.runtime.segment import process_segment
from vr_video_generator_tpu_torch.utils.logging import WorkerLog

torch.set_num_threads(2)

# The slice test's tiny model and geometry (tests/test_torch_pipeline.py):
# many live shifts, most left-eye pixels moved.
TINY = ModelConfig(encoder="vits", embed_dim=128, depth=2, num_heads=2,
                   mlp_ratio=4.0, features=16, out_channels=(8, 16, 32, 32),
                   intermediate_layers=(0, 1, 1, 1), depth_scaler=12.0,
                   mlp_fused="xla")
H, W, BATCH = 150, 96, 8
CFG = RunConfig(batch_size=BATCH, input_size=56, compute_dtype="float32",
                mlp_fused="xla", tail="xla")


@pytest.fixture(scope="module")
def weights():
    return random_state_dict(TINY, seed=2)


@pytest.fixture(scope="module")
def model(weights):
    return build_model(TINY, weights, torch.float32, "cpu")


@pytest.fixture(scope="module")
def jax_model(weights):
    return (JaxDepthAnythingV2(TINY, dtype=jnp.float32, tail="xla"),
            jax.tree.map(jnp.asarray, convert_state_dict(weights, TINY)))


def make_pipe(model, stride=1, batch=BATCH, **kw):
    return SbsPipeline(model, H, W, run_cfg=dataclasses.replace(
        CFG, batch_size=batch, depth_stride=stride, **kw))


def make_jax_pipe(jax_model, stride=1, batch=BATCH, **kw):
    jmodel, jparams = jax_model
    return JaxSbsPipeline(jmodel, jparams, H, W, run_cfg=dataclasses.replace(
        CFG, batch_size=batch, depth_stride=stride, **kw))


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(31).integers(0, 256, (3 * BATCH, H, W, 3),
                                              dtype=np.uint8)


def _lerp_ulps(got: np.ndarray, want: np.ndarray, prev0: np.ndarray,
               anchors: np.ndarray, stride: int) -> float:
    """The largest distance between two interpolations of ``anchors`` (the
    carried anchor ``prev0``) in units in the last place of the larger
    operand of each frame's lerp (bicubic depth dips below 0, so a result
    can be far smaller than its operands)."""
    prev = np.concatenate([prev0[None], anchors[:-1]])
    scale = np.maximum(np.abs(np.repeat(prev, stride, axis=0)),
                       np.abs(np.repeat(anchors, stride, axis=0)))
    ulp = np.spacing(scale.astype(np.float32)).astype(np.float64)
    return float(np.max(np.abs(got.astype(np.float64) - want) / ulp))


def _warm_state(h, w, stride, rng, jax_side=False):
    prev = rng.random((h, w), dtype=np.float32) * 14
    if jax_side:
        return jax_temporal.TemporalState.initial(
            h, w, depth_stride=stride)._replace(
                anchor_prev=jnp.asarray(prev), has_state=jnp.asarray(True))
    return TemporalState.initial(h, w, depth_stride=stride)._replace(
        anchor_prev=torch.from_numpy(prev), has_state=torch.tensor(True))


# ---------------------------------------------------------------- unit level

def test_stride_interpolate_weights_and_anchor_exactness():
    rng = np.random.default_rng(0)
    anchors = rng.random((3, 4, 5), dtype=np.float32)
    st = _warm_state(4, 5, 2, rng)
    depths, last = stride_interpolate(torch.from_numpy(anchors), st, 2)
    assert depths.shape == (6, 4, 5)
    d, prev = depths.numpy(), st.anchor_prev.numpy()
    # odd indices (group ends) are the anchors, bit for bit
    np.testing.assert_array_equal(d[1::2], anchors)
    np.testing.assert_allclose(d[0], 0.5 * (prev + anchors[0]), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(d[2], 0.5 * (anchors[0] + anchors[1]), rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(last.numpy(), anchors[-1])


def test_stride_interpolate_cold_start_holds_first_anchor():
    rng = np.random.default_rng(1)
    anchors = rng.random((2, 4, 5), dtype=np.float32)
    depths, _ = stride_interpolate(torch.from_numpy(anchors),
                                   TemporalState.initial(4, 5, depth_stride=4),
                                   4)
    d = depths.numpy()
    for j in range(4):  # group 0: lerp(anchor0, anchor0) = anchor0
        np.testing.assert_array_equal(d[j], anchors[0])
    np.testing.assert_allclose(d[5], 0.5 * (anchors[0] + anchors[1]), rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(d[7], anchors[1])


@pytest.mark.parametrize("stride", [2, 3, 4, 8])
@pytest.mark.parametrize("warm", [False, True])
def test_stride_interpolate_matches_jax(stride, warm):
    """The port's lerp against the JAX package's (jitted, as its pipeline
    runs it): anchors and the carried anchor bit for bit; the in-between
    frames bit for bit at stride 2 (weights 0.5 and 1 are exact either
    way) and within 1 ulp elsewhere (XLA's CPU FMA, module docstring)."""
    rng = np.random.default_rng(stride)
    anchors = rng.random((3, 37, 51), dtype=np.float32) * 14
    if warm:
        st = _warm_state(37, 51, stride, np.random.default_rng(9))
        jst = _warm_state(37, 51, stride, np.random.default_rng(9), True)
    else:
        st = TemporalState.initial(37, 51, depth_stride=stride)
        jst = jax_temporal.TemporalState.initial(37, 51, depth_stride=stride)
    jd, jlast = jax.jit(jax_temporal.stride_interpolate, static_argnums=2)(
        jnp.asarray(anchors), jst, stride)
    d, last = stride_interpolate(torch.from_numpy(anchors), st, stride)
    jd, d = np.asarray(jd), d.numpy()
    np.testing.assert_array_equal(d[stride - 1::stride], anchors)
    np.testing.assert_array_equal(np.asarray(jd)[stride - 1::stride], anchors)
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))
    prev0 = st.anchor_prev.numpy() if warm else anchors[0]
    if stride == 2:
        np.testing.assert_array_equal(d, jd)
    else:
        assert _lerp_ulps(d, jd, prev0, anchors, stride) <= 1


@pytest.mark.parametrize("stride", [2, 4])
def test_stride_audit_stats_match_jax(stride):
    """rms and max of the lerp-vs-true error over the non-anchor frames,
    against the JAX package's on the same depth and state (rtol 1e-5: the
    reductions run in another order)."""
    rng = np.random.default_rng(40 + stride)
    true = rng.random((2 * stride, 21, 33), dtype=np.float32) * 14
    st = _warm_state(21, 33, stride, np.random.default_rng(5))
    jst = _warm_state(21, 33, stride, np.random.default_rng(5), True)
    rms, mx = stride_audit_stats(torch.from_numpy(true), st, stride)
    jrms, jmx = jax.jit(jax_temporal.stride_audit_stats, static_argnums=2)(
        jnp.asarray(true), jst, stride)
    np.testing.assert_allclose([float(rms), float(mx)],
                               [float(jrms), float(jmx)], rtol=1e-5)
    assert float(mx) > 0 and float(rms) > 0


def test_temporal_state_carries_anchor_only_at_stride():
    st1 = TemporalState.initial(4, 5)
    assert st1.anchor_prev is None and st1.map(torch.clone).anchor_prev is None
    st2 = TemporalState.initial(4, 5, depth_stride=2)
    assert st2.anchor_prev.shape == (4, 5)
    assert st2._fields == jax_temporal.TemporalState._fields
    _, _, out = temporal_scan(torch.zeros(2, 4, 5), st2, make_spec(4, 5))
    assert out.anchor_prev is st2.anchor_prev  # passed through unchanged


def make_spec(h, w):
    from vr_video_generator_tpu_torch.ops.warp import WarpSpec
    from vr_video_generator_tpu_torch.utils.config import StereoConfig

    return WarpSpec.create(h, w, StereoConfig())


# ------------------------------------------------------------ pipeline level

def test_stride_pipeline_batch_continuity(model, frames):
    """Two 4-frame batches with the carried state == one 8-frame batch."""
    pipe = make_pipe(model, stride=2, batch=4)
    full, st_full = pipe.step(frames[:8], pipe.initial_state())
    st = pipe.initial_state()
    a, st = pipe.step(frames[:4], st)
    b, st = pipe.step(frames[4:8], st)
    np.testing.assert_array_equal(full.numpy(), torch.cat([a, b]).numpy())
    np.testing.assert_array_equal(st.anchor_prev.numpy(),
                                  st_full.anchor_prev.numpy())


def test_stride_equals_parity_path_on_static_video(model, frames):
    """A static scene: the lerp is the identity (weights 0.5 and 1), and
    the stride-2 output equals the stride-1 output bit for bit."""
    static = np.repeat(frames[:1], BATCH, axis=0)
    ref, _ = make_pipe(model).step(static, make_pipe(model).initial_state())
    p2 = make_pipe(model, stride=2)
    out, _ = p2.step(static, p2.initial_state())
    np.testing.assert_array_equal(ref.numpy(), out.numpy())


def test_stride_state_shape_and_validation(model, frames):
    pipe = make_pipe(model, stride=2, batch=4)
    assert pipe.initial_state().anchor_prev.shape == (H, W)
    assert make_pipe(model, batch=4).initial_state().anchor_prev is None
    with pytest.raises(ValueError, match="divide"):
        make_pipe(model, stride=3, batch=4)
    with pytest.raises(ValueError, match=">= 1"):
        make_pipe(model, stride=0, batch=4)
    with pytest.raises(ValueError, match="not divisible"):
        pipe.step(frames[:3], pipe.initial_state())


def test_stride_primed_state_carries_anchor(model, frames):
    """The halo warm-up composes with the stride: priming on the preceding
    frames puts the carried anchor and the smoothing state on the same
    trajectory as processing those frames."""
    pipe = make_pipe(model, stride=2, batch=4)
    _, st = pipe.step(frames[:4], pipe.initial_state())
    ref, _ = pipe.step(frames[4:8], st)
    primed = pipe.primed_state(frames[:4], batch_size=4)
    np.testing.assert_array_equal(primed.anchor_prev.numpy(),
                                  st.anchor_prev.numpy())
    assert int(primed.overflow) == 0
    out, _ = pipe.step(frames[4:8], primed)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


@pytest.mark.parametrize("stride", [2, 4])
def test_stride_step_matches_jax(model, jax_model, frames, stride):
    """Three batches of 8 with the carried state, against the JAX package's
    step at the same stride: the anchors' depth within 1e-4 of its peak;
    given the same anchor depth, the interpolated depth bit for bit at
    stride 2 and within 1 ulp at 4, and given the same interpolated depth,
    the blended depth, the ranges and the SBS bit for bit; the whole step's
    right half equal to the input and its left half equal to JAX's on >=
    99.9% of pixels (an f32 ulp of depth can move a pixel across a band
    edge), the carried anchor within 1e-4 of its peak."""
    pipe = make_pipe(model, stride=stride)
    jpipe = make_jax_pipe(jax_model, stride=stride)
    state, jstate = pipe.initial_state(), jpipe.initial_state()
    wst = TemporalState.initial(H, W, depth_stride=stride)
    jwst = jax_temporal.TemporalState.initial(H, W, depth_stride=stride)
    for i in range(3):
        batch = frames[i * BATCH:(i + 1) * BATCH]
        ja = np.asarray(jpipe.depth_only(batch[stride - 1::stride]))
        a = pipe.depth_only(batch[stride - 1::stride]).numpy()
        assert np.abs(a - ja).max() <= 1e-4 * np.abs(ja).max()

        jd, jlast = jax.jit(jax_temporal.stride_interpolate,
                            static_argnums=2)(jnp.asarray(ja), jwst, stride)
        d, last = stride_interpolate(torch.from_numpy(ja.copy()), wst, stride)
        jd = np.asarray(jd)
        prev0 = wst.anchor_prev.numpy() if i else ja[0]
        if stride == 2:
            np.testing.assert_array_equal(d.numpy(), jd)
        else:
            assert _lerp_ulps(d.numpy(), jd, prev0, ja, stride) <= 1
        jblend, jranges, jwst = jax_temporal.temporal_scan(
            jnp.asarray(jd), jwst, jpipe.spec)
        jwst = jwst._replace(anchor_prev=jlast)
        blend, ranges, wst = temporal_scan(torch.from_numpy(jd.copy()), wst,
                                           pipe.spec)
        wst = wst._replace(anchor_prev=torch.from_numpy(ja[-1].copy()))
        np.testing.assert_array_equal(blend.numpy(), np.asarray(jblend))
        np.testing.assert_array_equal(ranges.numpy(), np.asarray(jranges))
        np.testing.assert_array_equal(
            pipe.spec.warp_batch(torch.from_numpy(batch), blend,
                                 ranges).numpy(),
            np.asarray(jpipe.spec.warp_batch(jnp.asarray(batch), jblend,
                                             jranges)))

        jsbs, jstate = jpipe.step(batch, jstate)
        sbs, state = pipe.step(batch, state)
        jsbs, sbs = np.asarray(jsbs), sbs.numpy()
        np.testing.assert_array_equal(sbs[:, :, W:], batch)
        assert np.any(sbs[:, :, :W] != batch, axis=-1).mean() > 0.5
        same = np.all(sbs[:, :, :W] == jsbs[:, :, :W], axis=-1).mean()
        assert same >= 0.999, f"batch {i}: {same:.5f} of left pixels equal"
        jprev = np.asarray(jstate.anchor_prev)
        assert np.abs(state.anchor_prev.numpy() - jprev).max() \
            <= 1e-4 * np.abs(jprev).max()
    np.testing.assert_allclose(state.offset_range.numpy(),
                               np.asarray(jstate.offset_range), rtol=1e-5)


# ------------------------------------------------------------- audit level

def test_stride_audit_zero_on_static_video(model, frames):
    """Identical frames: the anchors are equal and the lerp is the identity,
    so the error sits at the noise floor (the port's CPU forward is
    row-identical: exactly 0)."""
    pipe = make_pipe(model, stride=2, batch=4)
    rms, mx = pipe.stride_audit(np.repeat(frames[:1], 4, axis=0),
                                pipe.initial_state())
    assert rms < 1e-8 and mx < 1e-6


def test_stride_audit_detects_motion_and_is_read_only(model, frames):
    """Changing frames give a nonzero error; the audit leaves the state and
    the next step's output as they were."""
    pipe = make_pipe(model, stride=2, batch=4)
    ref, _ = pipe.step(frames[:4], pipe.initial_state())
    st = pipe.initial_state()
    before = st.map(torch.clone)
    rms, mx = pipe.stride_audit(frames[:4], st)
    assert np.isfinite(rms) and np.isfinite(mx) and mx >= rms > 0.0
    for x, y in zip(st, before):
        assert torch.equal(x, y)
    out, _ = pipe.step(frames[:4], st)
    np.testing.assert_array_equal(ref.numpy(), out.numpy())
    with pytest.raises(ValueError, match="depth_stride"):
        make_pipe(model, batch=4).stride_audit(frames[:4], st)


def test_step_audited_matches_parity_output_and_audit_stats(model, frames):
    """step_audited = the stride-1 step's output plus the read-only audit's
    stats, and the carried anchor is the true raw depth of the batch's last
    frame (an anchor position: batch % stride == 0)."""
    strided, parity = make_pipe(model, stride=2), make_pipe(model)
    batch = frames[:BATCH]
    ref_rms, ref_mx = strided.stride_audit(batch, strided.initial_state())
    ref_sbs, ref_st = parity.step(batch, parity.initial_state())
    sbs, st, rms, mx = strided.step_audited(batch, strided.initial_state())
    np.testing.assert_array_equal(sbs.numpy(), ref_sbs.numpy())
    assert (rms, mx) == (ref_rms, ref_mx)
    np.testing.assert_array_equal(
        st.anchor_prev.numpy(), strided.depth_only(batch)[-1].numpy())
    for name in ("d_prev1", "d_prev2", "offset_range", "has_state",
                 "overflow"):
        assert torch.equal(getattr(st, name), getattr(ref_st, name)), name


def test_step_audited_matches_jax(model, jax_model, frames):
    """Against the JAX package's step_audited on two batches from the cold
    start: the SBS as the step's (right half the input, left >= 99.9%
    equal), rms and max within 2e-4 of the depth's peak (each depth value
    is within 1e-4 of it, so the error field is within 2e-4), the carried
    anchor within 1e-4."""
    pipe, jpipe = make_pipe(model, stride=2), make_jax_pipe(jax_model,
                                                            stride=2)
    st, jst = pipe.initial_state(), jpipe.initial_state()
    for i in range(2):
        batch = frames[i * BATCH:(i + 1) * BATCH]
        peak = float(np.abs(np.asarray(jpipe.depth_only(batch))).max())
        jsbs, jst, jrms, jmx = jpipe.step_audited(batch, jst)
        sbs, st, rms, mx = pipe.step_audited(batch, st)
        np.testing.assert_array_equal(sbs.numpy()[:, :, W:], batch)
        same = np.all(sbs.numpy()[:, :, :W] == np.asarray(jsbs)[:, :, :W],
                      axis=-1).mean()
        assert same >= 0.999
        assert abs(rms - jrms) <= 2e-4 * peak and abs(mx - jmx) <= 2e-4 * peak
        assert np.abs(st.anchor_prev.numpy()
                      - np.asarray(jst.anchor_prev)).max() <= 1e-4 * peak


def test_step_audited_requires_stride(model):
    with pytest.raises(ValueError, match="depth_stride"):
        make_pipe(model, batch=4).step_audited(
            np.zeros((4, H, W, 3), np.uint8), None)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_step_many_at_stride_equals_k_steps(model, frames, as_tensor):
    """step_many at stride 2 (k = 3 batches of 8) against 3 step() calls,
    bit for bit, the SBS and every state field, anchor_prev included."""
    pipe = make_pipe(model, stride=2)
    chunk = frames.reshape(3, BATCH, H, W, 3)
    many, st_many = pipe.step_many(torch.from_numpy(chunk) if as_tensor
                                   else chunk, pipe.initial_state())
    st = pipe.initial_state()
    for got, batch in zip(many, chunk):
        want, st = pipe.step(batch, st)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    for x, y in zip(st_many, st):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ----------------------------------------------------------- segment level

class _Reader:
    def __init__(self, frames):
        self.frames, self.pos = frames, 0
        self.height, self.width = frames.shape[1], frames.shape[2]

    def read_into(self, out):
        out[...] = self.frames[self.pos]
        self.pos += 1
        return True


class _Writer:
    def __init__(self):
        self.frames = []

    def write_clip(self, begin, frames):
        self.frames.extend(frames)

    def wait(self):
        pass


def _segment(pipe, frames, batch, log_path=None):
    writer = _Writer()
    log = WorkerLog(str(log_path)) if log_path else None
    try:
        n = process_segment(pipe, _Reader(frames), writer, 0, len(frames),
                            max_frame_count=8, batch_size=batch, log=log)
    finally:
        if log:
            log.close()
    assert n == len(frames)
    return np.stack(writer.frames)


def test_stride_audit_logged_by_segment_runner(model, frames, tmp_path):
    """--stride_audit_every 2 over 10 frames at batch 4 (batches 4, 4, 2 +
    pad): one audit line, for frames [0, 4) (batch 1 is not sampled, the
    padded batch 2 is skipped), in the JAX package's format; the output is
    the plain strided run's."""
    pipe = make_pipe(model, stride=2, batch=4, stride_audit_every=2)
    log_path = tmp_path / "seg.txt"
    out = _segment(pipe, frames[:10], 4, log_path)
    lines = [ln for ln in log_path.read_text().splitlines()
             if "stride audit" in ln]
    assert len(lines) == 1 and "frames [0, 4)" in lines[0]
    assert "rms=" in lines[0] and "max=" in lines[0]
    np.testing.assert_array_equal(
        out, _segment(make_pipe(model, stride=2, batch=4), frames[:10], 4))


def test_segment_audit_lines_match_jax(model, jax_model, frames, tmp_path):
    """The observe-only audit through both packages' segment loops on the
    same frames (12 at batch 4, every batch probed): the same audit lines
    for the same frame ranges, their rms and max within 2e-4 of the depth's
    peak."""
    from vr_video_generator_tpu.runtime.segment import (
        process_segment as jax_process_segment)
    from vr_video_generator_tpu.utils.logging import WorkerLog as JaxLog

    import re

    clip = frames[:12]
    pipe = make_pipe(model, stride=2, batch=4, stride_audit_every=1)
    jpipe = make_jax_pipe(jax_model, stride=2, batch=4, stride_audit_every=1)
    _segment(pipe, clip, 4, tmp_path / "port.txt")
    jlog = JaxLog(str(tmp_path / "jax.txt"))
    jax_process_segment(jpipe, _Reader(clip), _Writer(), 0, 12,
                        max_frame_count=8, batch_size=4, log=jlog)
    jlog.close()
    pat = re.compile(r"stride audit frames \[(\d+), (\d+)\): .* "
                     r"rms=([0-9.]+) max=([0-9.]+)")

    def audits(path):
        return [pat.search(ln).groups() for ln in path.read_text().splitlines()
                if "stride audit" in ln]

    got, want = audits(tmp_path / "port.txt"), audits(tmp_path / "jax.txt")
    assert [g[:2] for g in got] == [w[:2] for w in want] \
        == [("0", "4"), ("4", "8"), ("8", "12")]
    peak = float(np.abs(np.asarray(jpipe.depth_only(clip))).max())
    for g, w in zip(got, want):
        for a, b in zip(g[2:], w[2:]):
            # the log prints 4 decimals
            assert abs(float(a) - float(b)) <= 2e-4 * peak + 1e-4


@pytest.mark.parametrize("chunk", [1, 3])
def test_adaptive_extremes_render_full_depth_or_probe_schedule(model, frames,
                                                               chunk):
    """stride_max_rms 1e-30: the first probe drops to full depth and no
    batch re-raises, so the output is the stride-1 run's, byte for byte.
    stride_max_rms 1e30 with stride_audit_every 2: probes (batches 0 and 2)
    render at full depth through step_audited and never drop; batch 1 runs
    strided: the output is that schedule's, run by hand. Both at
    chunk_batches 1 and 3."""
    clip = frames[:3 * 4]
    parity = _segment(make_pipe(model, batch=4), clip, 4)
    low = make_pipe(model, stride=2, batch=4, stride_max_rms=1e-30,
                    chunk_batches=chunk)
    np.testing.assert_array_equal(_segment(low, clip, 4), parity)

    high = make_pipe(model, stride=2, batch=4, stride_max_rms=1e30,
                     stride_audit_every=2, chunk_batches=chunk)
    st, want = high.initial_state(), []
    for i in range(3):
        batch = clip[4 * i:4 * i + 4]
        if i % 2 == 0:
            sbs, st, _, _ = high.step_audited(batch, st)
        else:
            sbs, st = high.step(batch, st)
        want.append(sbs.numpy())
    np.testing.assert_array_equal(_segment(high, clip, 4),
                                  np.concatenate(want))


def test_chunk_flushes_before_a_probe(model, frames, monkeypatch):
    """chunk_batches 3 with stride_audit_every 3 over 7 batches of 4: batch
    0 is probed alone (stride_audit, then step), batches 1-2 go as one
    chunk flushed before probe 3, batches 4-5 as one chunk flushed before
    probe 6 (the stream's last batch)."""
    calls = []
    real = {n: getattr(SbsPipeline, n)
            for n in ("step", "step_many", "stride_audit")}
    depth = [0]

    def spy(name):
        def fn(self, fr, state, *a, **k):
            if depth[0] == 0:
                calls.append((name, tuple(fr.shape)[:1]))
            depth[0] += 1
            try:
                return real[name](self, fr, state, *a, **k)
            finally:
                depth[0] -= 1
        return fn

    for name in real:
        monkeypatch.setattr(SbsPipeline, name, spy(name))
    pipe = make_pipe(model, stride=2, batch=4, chunk_batches=3,
                     stride_audit_every=3)
    _segment(pipe, np.concatenate([frames, frames[:4]]), 4)
    assert calls == [("stride_audit", (4,)), ("step", (4,)),
                     ("step_many", (2,)), ("stride_audit", (4,)),
                     ("step", (4,)), ("step_many", (2,)),
                     ("stride_audit", (4,)), ("step", (4,))]


def test_adaptive_stride_drops_and_reraises_and_renders_clean(model, tmp_path):
    """The self-protecting stride end to end (tests/test_depth_stride.py's
    contract): a fast-pan section that diverges under a fixed stride renders
    bit-equal to the stride-1 run under the adaptive stride, with one drop
    to full depth at frame 8 and one re-raise in the worker log.

    Batch 4, stride 2, a probe every 2nd batch, hold 2: batches 0-1 a static
    scene (the probe passes; batch 1 strided, exact on a static scene);
    2-3 per-frame noise (probe 2 trips: full depth; 3 stays full); 4-7 a
    second static scene (4 still errs through the carried anchor, 5-6
    subside, the stride re-raises after 6; 7 strided, exact again)."""
    rng = np.random.default_rng(11)
    static_a = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    static_b = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    clip = np.concatenate([np.repeat(static_a[None], 8, axis=0),
                           rng.integers(0, 256, (8, H, W, 3), dtype=np.uint8),
                           np.repeat(static_b[None], 16, axis=0)])
    # Ten times the default offsets: about one depth unit a plane at this
    # height, the plane density of a 1080p frame.
    base = dict(stride=2, batch=4, offset_fg=0.25, offset_bg=-0.1)
    probe = make_pipe(model, **base)

    def regime_rms(anchor_frame, batch):
        st = probe.initial_state()._replace(
            anchor_prev=probe.depth_only(anchor_frame[None])[0],
            has_state=torch.tensor(True))
        return probe.stride_audit(batch, st)[0]

    rms_motion = regime_rms(clip[7], clip[8:12])
    rms_static = regime_rms(clip[19], clip[20:24])
    assert rms_motion > 10 * max(rms_static, 1e-9)
    threshold = float(np.sqrt(max(rms_static, 1e-12) * rms_motion))

    log_path = tmp_path / "adaptive.txt"
    adaptive = _segment(make_pipe(model, **base, stride_max_rms=threshold,
                                  stride_audit_every=2, stride_hold=2),
                        clip, 4, log_path)
    parity = _segment(make_pipe(model, **dict(base, stride=1)), clip, 4)
    fixed = _segment(make_pipe(model, **base), clip, 4)
    text = log_path.read_text().splitlines()
    drops = [ln for ln in text if "dropped to full depth" in ln]
    raises_ = [ln for ln in text if "re-raised to stride" in ln]
    assert len(drops) == 1 and "at frame 8" in drops[0]
    assert len(raises_) == 1 and "stride 2 at frame 28" in raises_[0]
    assert (fixed[8:16] != parity[8:16]).any()
    np.testing.assert_array_equal(adaptive, parity)


# ------------------------------------------------------ bench and the study

def test_bench_depth_stride_on_cpu(capsys):
    """The port's bench at --depth_stride 2 on the CPU (the root bench's
    smoke geometry, batch max(2, S)): the metric carries ``_stride2``; a
    config whose batch the stride does not divide is skipped with a
    message and no line."""
    import json

    from vr_video_generator_tpu_torch import bench

    assert bench.main(["--device", "cpu", "--depth_stride", "2", "--steps",
                       "2", "--reps", "1", "--segment_batches", "2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "torch_sbs_fps_270p_vits_stride2"
    assert line["depth_stride"] == 2 and line["value"] > 0
    assert line["host_fps"] > 0 and line["card"] is None
    assert bench.main(["--config", "4", "--depth_stride", "8"]) == 0
    out = capsys.readouterr()
    assert out.out == "" and "does not divide its batch 4" in out.err


def test_stride_study_on_cpu(capsys):
    """The port's stride study at its CPU geometry (the script's tiny model,
    56 x 98, 16 frames): three arms x two speeds x strides 2, 4, 8, each
    row with finite depth and SBS figures; stride 1 is the reference, so
    the anchors' lerp has zero error at the anchors and the coherent arm's
    error grows with the pan speed at stride 2."""
    import json

    from vr_video_generator_tpu_torch import stride_study

    assert stride_study.main(["--device", "cpu", "--frames", "16"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rows = out["rows"]
    assert len(rows) == 18 and out["frames"] == 16
    assert {(r["arm"], r["scene"], r["stride"]) for r in rows} == {
        (a, sc, s) for a in ("random", "spread", "coherent")
        for sc in ("slow", "fast") for s in (2, 4, 8)}
    for r in rows:
        assert all(np.isfinite(v) and v >= 0 for k, v in r.items()
                   if isinstance(v, float))
    coherent = {(r["scene"], r["stride"]): r["depth_rms_pct"] for r in rows
                if r["arm"] == "coherent"}
    assert coherent[("fast", 2)] > coherent[("slow", 2)] > 0
    depth = stride_study.make_depth(16, 56, 98, 1)
    lerped = stride_study.interp_depth(depth, 4)
    np.testing.assert_array_equal(lerped[3::4], depth[3::4])
