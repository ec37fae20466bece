"""PyTorch port: SbsPipeline.step_many and the chunked segment loop
(--chunk_batches) on the CPU, against k step() calls and against the JAX
package's step_many; the ValueError on a 4-D input; HostStaging's chunk
upload and readback."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.depth_anything_v2 import (
    DepthAnythingV2 as JaxDepthAnythingV2)
from vr_video_generator_tpu.pipeline import SbsPipeline as JaxSbsPipeline
from vr_video_generator_tpu.utils.config import ModelConfig, RunConfig
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.pipeline import SbsPipeline, check_supported
from vr_video_generator_tpu_torch.runtime.segment import (HostStaging,
                                                          process_segment)

torch.set_num_threads(2)

# The slice test's tiny model and geometry (tests/test_torch_pipeline.py):
# many live shifts, most left-eye pixels moved.
TINY = ModelConfig(encoder="vits", embed_dim=128, depth=2, num_heads=2,
                   mlp_ratio=4.0, features=16, out_channels=(8, 16, 32, 32),
                   intermediate_layers=(0, 1, 1, 1), depth_scaler=12.0,
                   mlp_fused="xla")
H, W, BATCH, K = 150, 96, 4, 3
CFG = RunConfig(batch_size=BATCH, input_size=56, compute_dtype="float32",
                mlp_fused="xla", tail="xla")
FIELDS = ("d_prev1", "d_prev2", "offset_range", "has_state", "overflow",
          "anchor_prev")


@pytest.fixture(scope="module")
def weights():
    return random_state_dict(TINY, seed=2)


@pytest.fixture(scope="module")
def model(weights):
    return build_model(TINY, weights, torch.float32, "cpu")


@pytest.fixture(scope="module")
def pipe(model):
    return SbsPipeline(model, H, W, run_cfg=CFG)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(23).integers(0, 256, (K, BATCH, H, W, 3),
                                              dtype=np.uint8)


def _sequential(pipe, frames, state):
    outs = []
    for batch in frames:
        sbs, state = pipe.step(batch, state)
        outs.append(sbs)
    return outs, state


def _assert_states_equal(a, b):
    assert a._fields == FIELDS
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if name == "anchor_prev":  # None at depth_stride 1
            assert x is None and y is None
            continue
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=name)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_step_many_equals_k_steps_bit_for_bit(pipe, frames, as_tensor):
    """k = 3 whole batches of 4 in one call: each SBS and every state field
    bit-equal to 3 step() calls, from the cold start; numpy or tensor
    frames alike."""
    fr = torch.from_numpy(frames) if as_tensor else frames
    many, st_many = pipe.step_many(fr, pipe.initial_state())
    assert isinstance(many, tuple) and len(many) == K
    outs, st = _sequential(pipe, frames, pipe.initial_state())
    for got, want in zip(many, outs):
        assert got.shape == (BATCH, H, 2 * W, 3) and got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    _assert_states_equal(st_many, st)


def test_step_many_carries_a_warm_state(pipe, frames):
    """From a state some batches in (the segment loop's second chunk):
    still equal to the steps, and the state goes on as theirs does."""
    _, warm = pipe.step(frames[2], pipe.initial_state())
    many, st_many = pipe.step_many(frames[:2], warm)
    outs, st = _sequential(pipe, frames[:2], warm)
    for got, want in zip(many, outs):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    _assert_states_equal(st_many, st)
    again, _ = pipe.step_many(frames[1:], st_many)
    outs, _ = _sequential(pipe, frames[1:], st)
    for got, want in zip(again, outs):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("shape", [(BATCH, H, W, 3), (H, W, 3),
                                   (1, 1, BATCH, H, W, 3)])
def test_step_many_rejects_other_ranks(pipe, shape):
    """Only (k, B, H, W, 3) is taken; a 4-D batch (step's input) raises a
    ValueError that names step_many, numpy or tensor."""
    arr = np.zeros(shape, np.uint8)
    for x in (arr, torch.from_numpy(arr)):
        with pytest.raises(ValueError, match="step_many"):
            pipe.step_many(x, pipe.initial_state())


def test_step_many_matches_jax_step_many(pipe, weights, frames):
    """The port's step_many against the JAX package's on the same converted
    weights, held as the slice test holds step(): the right half bit-equal
    to the input, the left half equal on >= 99.9% of pixels (an f32 ulp of
    depth can move a pixel across a band edge), the carried raw depth
    within 1e-4 of its peak and the offset range within 1e-5 relative."""
    jmodel = JaxDepthAnythingV2(TINY, dtype=jnp.float32, tail="xla")
    jparams = jax.tree.map(jnp.asarray, convert_state_dict(weights, TINY))
    jpipe = JaxSbsPipeline(jmodel, jparams, H, W, run_cfg=CFG)
    jmany, jst = jpipe.step_many(frames, jpipe.initial_state())
    many, st = pipe.step_many(frames, pipe.initial_state())
    assert len(jmany) == len(many) == K
    for i, (j, t) in enumerate(zip(jmany, many)):
        j, t = np.asarray(j), t.numpy()
        np.testing.assert_array_equal(t[:, :, W:], frames[i])
        np.testing.assert_array_equal(j[:, :, W:], frames[i])
        assert np.any(t[:, :, :W] != frames[i], axis=-1).mean() > 0.5
        same = np.all(t[:, :, :W] == j[:, :, :W], axis=-1).mean()
        assert same >= 0.999, f"batch {i}: {same:.5f} of left pixels equal"
    for name in ("d_prev1", "d_prev2"):
        jd = np.asarray(getattr(jst, name))
        assert np.abs(getattr(st, name).numpy() - jd).max() \
            <= 1e-4 * np.abs(jd).max(), name
    np.testing.assert_allclose(st.offset_range.numpy(),
                               np.asarray(jst.offset_range), rtol=1e-5)
    assert bool(st.has_state) and bool(jst.has_state)
    assert int(st.overflow) == int(jst.overflow)


@pytest.mark.parametrize("chunk", [2, 3, 8])
def test_check_supported_lets_chunks_through(chunk):
    """--chunk_batches > 1 is ported; 0 is refused as the JAX package
    refuses it. With it, depth_stride 2 passes (it divides the batch of
    4) and depth_stride 3 raises the JAX package's ValueError."""
    check_supported(dataclasses.replace(CFG, chunk_batches=chunk))
    with pytest.raises(ValueError, match="chunk_batches"):
        check_supported(dataclasses.replace(CFG, chunk_batches=0))
    check_supported(dataclasses.replace(CFG, chunk_batches=chunk,
                                        depth_stride=2))
    with pytest.raises(ValueError, match="must divide batch_size"):
        check_supported(dataclasses.replace(CFG, chunk_batches=chunk,
                                            depth_stride=3))


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
        self.clips = []

    def write_clip(self, begin, frames):
        self.clips.append((begin, np.stack(frames)))

    def wait(self):
        pass


def _segment(model, frames, chunk, max_frame_count=8, discard_first=0):
    pipe = SbsPipeline(model, H, W, run_cfg=dataclasses.replace(
        CFG, chunk_batches=chunk))
    writer = _Writer()
    n = process_segment(pipe, _Reader(frames), writer, discard_first,
                        len(frames), max_frame_count=max_frame_count,
                        batch_size=BATCH, discard_first=discard_first)
    return n, writer.clips, pipe


@pytest.fixture(scope="module")
def frames22():
    return np.random.default_rng(29).integers(0, 256, (22, H, W, 3),
                                              dtype=np.uint8)


@pytest.mark.parametrize("chunk,max_frame_count,discard_first", [
    (3, 8, 0), (3, 5, 3), (2, 8, 0), (6, 8, 0)])
def test_chunked_segment_writes_the_same_subclips(model, frames22, chunk,
                                                  max_frame_count,
                                                  discard_first):
    """22 frames at batch 4 (five full batches and a short one of 2):
    chunks of 2, 3 or 6 write the same subclips, frame for frame and byte
    for byte, as per-batch dispatch, with and without discarded leading
    frames."""
    n1, clips1, _ = _segment(model, frames22, 1, max_frame_count,
                             discard_first)
    nk, clipsk, _ = _segment(model, frames22, chunk, max_frame_count,
                             discard_first)
    assert n1 == nk == 22 - discard_first
    assert [b for b, _ in clipsk] == [b for b, _ in clips1] \
        == list(range(discard_first, 22, max_frame_count))
    for (_, a), (_, b) in zip(clips1, clipsk):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_chunked_segment_dispatch_pattern(model, frames22, monkeypatch):
    """At chunk 3: one step_many of 3, one of the remaining 2 full batches,
    then the padded short batch alone through step with n_valid = 2."""
    calls = []
    real_step, real_many = SbsPipeline.step, SbsPipeline.step_many

    def step(self, frames, state, n_valid=None):
        calls.append(("step", tuple(frames.shape), n_valid))
        return real_step(self, frames, state, n_valid=n_valid)

    def step_many(self, frames, state):
        calls.append(("step_many", tuple(frames.shape)))
        outs, st = real_many(self, frames, state)
        calls.append("end")
        return outs, st

    monkeypatch.setattr(SbsPipeline, "step", step)
    monkeypatch.setattr(SbsPipeline, "step_many", step_many)
    _segment(model, frames22, 3)
    top = []
    depth = 0
    for c in calls:  # drop the steps step_many itself makes on the CPU
        if c == "end":
            depth -= 1
        elif c[0] == "step_many":
            top.append(c)
            depth += 1
        elif depth == 0:
            top.append(c)
    assert top == [("step_many", (3, BATCH, H, W, 3)),
                   ("step_many", (2, BATCH, H, W, 3)),
                   ("step", (BATCH, H, W, 3), 2)]


def test_host_staging_stacks_a_chunk_on_the_cpu():
    """On the CPU a chunk's batches go up as one (k, B, H, W, 3) stack and
    its k outputs come back as one (k B, ...) array, in order."""
    staging = HostStaging(torch.device("cpu"))
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
               for _ in range(3)]
    up = staging.upload(batches)
    assert tuple(up.shape) == (3, 2, 5, 7, 3)
    np.testing.assert_array_equal(up.numpy(), np.stack(batches))
    np.testing.assert_array_equal(staging.upload(batches[1]).numpy(),
                                  batches[1])
    outs = tuple(torch.from_numpy(b) for b in batches)
    back = staging.finish_readback(staging.start_readback(outs))
    np.testing.assert_array_equal(back, np.concatenate(batches))
