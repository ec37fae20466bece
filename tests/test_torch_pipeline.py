"""PyTorch port, the slice: SbsPipeline against the JAX SbsPipeline, the
pipeline and segment contracts, the CLI on the CPU, and the explicit
failures of what is not ported."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.depth_anything_v2 import (
    DepthAnythingV2 as JaxDepthAnythingV2)
from vr_video_generator_tpu.ops.temporal import (TemporalState as
                                                 JaxTemporalState,
                                                 temporal_scan as
                                                 jax_temporal_scan)
from vr_video_generator_tpu.pipeline import SbsPipeline as JaxSbsPipeline
from vr_video_generator_tpu.utils.config import ModelConfig, RunConfig
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.ops.temporal import (TemporalState,
                                                       temporal_scan)
from vr_video_generator_tpu_torch.pipeline import SbsPipeline, check_supported
from vr_video_generator_tpu_torch.runtime.segment import process_segment

torch.set_num_threads(2)

# The depth scaler lifts the random net's raw depth (max ~0.2) to ~[0, 14]
# and 150 rows give a (5, 3) blur window, so many shifts are live and the
# warp moves most pixels.
TINY = ModelConfig(encoder="vits", embed_dim=128, depth=2, num_heads=2,
                   mlp_ratio=4.0, features=16, out_channels=(8, 16, 32, 32),
                   intermediate_layers=(0, 1, 1, 1), depth_scaler=12.0,
                   mlp_fused="xla")
H, W, BATCH = 150, 96, 4
CFG = RunConfig(batch_size=BATCH, input_size=56, compute_dtype="float32",
                mlp_fused="xla", tail="xla")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def weights():
    return random_state_dict(TINY, seed=2)


@pytest.fixture(scope="module")
def pipe(weights):
    return SbsPipeline(build_model(TINY, weights, torch.float32, "cpu"), H, W,
                       run_cfg=CFG)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(11).integers(0, 256, (3 * BATCH, H, W, 3),
                                              dtype=np.uint8)


def test_slice_matches_jax_pipeline(pipe, weights, frames):
    """Three consecutive batches with carried state: depth within 1e-4
    relative, the right half bit-equal to the input, the warp bit-exact
    given identical depth, and the left half equal on >= 99.9% of pixels
    (an f32 ulp of depth can move a pixel across a band edge)."""
    jmodel = JaxDepthAnythingV2(TINY, dtype=jnp.float32, tail="xla")
    jparams = jax.tree.map(jnp.asarray, convert_state_dict(weights, TINY))
    jpipe = JaxSbsPipeline(jmodel, jparams, H, W, run_cfg=CFG)
    jstate, state = jpipe.initial_state(), pipe.initial_state()
    wstate, jwstate = TemporalState.initial(H, W), JaxTemporalState.initial(H, W)
    for i in range(3):
        batch = frames[i * BATCH:(i + 1) * BATCH]
        jdepth = np.asarray(jpipe.depth_only(batch))
        depth = pipe.depth_only(batch).numpy()
        assert np.abs(depth - jdepth).max() <= 1e-4 * np.abs(jdepth).max()

        # the warp of identical depth, through both temporal scans
        jblend, jranges, jwstate = jax_temporal_scan(jnp.asarray(jdepth),
                                                     jwstate, jpipe.spec)
        jsbs_warp = np.asarray(jpipe.spec.warp_batch(
            jnp.asarray(batch), jblend, jranges))
        blend, ranges, wstate = temporal_scan(torch.from_numpy(jdepth.copy()),
                                              wstate, pipe.spec)
        np.testing.assert_array_equal(blend.numpy(), np.asarray(jblend))
        np.testing.assert_array_equal(ranges.numpy(), np.asarray(jranges))
        np.testing.assert_array_equal(
            pipe.spec.warp_batch(torch.from_numpy(batch), blend, ranges).numpy(),
            jsbs_warp)

        jsbs, jstate = jpipe.step(batch, jstate)
        sbs, state = pipe.step(batch, state)
        jsbs, sbs = np.asarray(jsbs), sbs.numpy()
        np.testing.assert_array_equal(sbs[:, :, W:], batch)
        np.testing.assert_array_equal(jsbs[:, :, W:], batch)
        # the warp is not degenerate: most left-eye pixels moved
        assert np.any(sbs[:, :, :W] != batch, axis=-1).mean() > 0.5
        same = np.all(sbs[:, :, :W] == jsbs[:, :, :W], axis=-1).mean()
        assert same >= 0.999, f"batch {i}: {same:.5f} of left pixels equal"
    np.testing.assert_allclose(state.offset_range.numpy(),
                               np.asarray(jstate.offset_range), rtol=1e-5)


def test_step_shapes_and_dtype(pipe, frames):
    sbs, state = pipe.step(frames[:BATCH], pipe.initial_state())
    assert sbs.shape == (BATCH, H, 2 * W, 3) and sbs.dtype == torch.uint8
    np.testing.assert_array_equal(sbs[:, :, W:].numpy(), frames[:BATCH])
    assert bool(state.has_state) and state.overflow.dtype == torch.int32


def test_batch_boundaries_are_invisible(pipe, frames):
    full, st_full = pipe.step(frames[:4], pipe.initial_state())
    st = pipe.initial_state()
    a, st = pipe.step(frames[:2], st)
    b, st = pipe.step(frames[2:4], st)
    np.testing.assert_array_equal(full.numpy(), torch.cat([a, b]).numpy())
    np.testing.assert_array_equal(st.d_prev1.numpy(), st_full.d_prev1.numpy())
    np.testing.assert_array_equal(st.offset_range.numpy(),
                                  st_full.offset_range.numpy())


def test_primed_state_removes_segment_reset(pipe, frames):
    st = pipe.initial_state()
    outs = []
    for lo in range(0, 12, 4):
        sbs, st = pipe.step(frames[lo:lo + 4], st)
        outs.append(sbs.numpy())
    full = np.concatenate(outs)
    # 6 warm-up frames at batch 4 front-pad 2 copies of frame 0
    primed = pipe.primed_state(frames[:6], batch_size=4)
    assert bool(primed.has_state) and int(primed.overflow) == 0
    sbs, _ = pipe.step(frames[6:10], primed)
    np.testing.assert_array_equal(sbs.numpy(), full[6:10])
    sbs2, after = pipe.step(frames[8:12],
                            pipe.primed_state(frames[:8], batch_size=4))
    np.testing.assert_array_equal(sbs2.numpy(), full[8:12])
    np.testing.assert_array_equal(after.offset_range.numpy(),
                                  st.offset_range.numpy())
    assert not bool(pipe.primed_state(frames[:0], batch_size=4).has_state)


def test_n_valid_masks_overflow_tally(pipe):
    """Only the first n_valid frames count toward the over-cap tally, and
    the depth is clamped at the cap."""
    raw = np.full((4, H, W), 5.0, np.float32)
    raw[1:, 0, 0] = 40.0  # frames 1..3 exceed limit_step_cap (24)
    for n_valid, want in ((None, 3), (2, 1), (1, 0)):
        blended, _, st = temporal_scan(torch.from_numpy(raw),
                                       TemporalState.initial(H, W), pipe.spec,
                                       n_valid=n_valid)
        _, _, jst = jax_temporal_scan(jnp.asarray(raw),
                                      JaxTemporalState.initial(H, W),
                                      pipe.spec, n_valid=n_valid)
        assert int(st.overflow) == int(jst.overflow) == want
        assert float(blended.max()) <= 24.0


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
        self.clips, self.waited = [], False

    def write_clip(self, begin, frames):
        self.clips.append((begin, np.stack(frames)))

    def wait(self):
        self.waited = True


@pytest.mark.parametrize("discard_first", [0, 3])
def test_process_segment_matches_sequential_steps(pipe, frames, discard_first):
    """10 frames at batch 4: the short last batch is padded, clips follow
    Max_Frame_Count, the output equals plain step() calls, and the
    discarded leading frames only advance the state."""
    n = 10
    writer = _Writer()
    written = process_segment(pipe, _Reader(frames[:n]), writer,
                              discard_first, n, max_frame_count=3,
                              batch_size=BATCH, discard_first=discard_first)
    assert written == n - discard_first and writer.waited
    assert [b for b, _ in writer.clips] == list(range(discard_first, n, 3))
    got = np.concatenate([c for _, c in writer.clips])
    st, want = pipe.initial_state(), []
    for lo in range(0, n, BATCH):
        batch = frames[lo:min(lo + BATCH, n)]
        pad = np.repeat(batch[-1:], BATCH - len(batch), axis=0)
        sbs, st = pipe.step(np.concatenate([batch, pad]), st)
        want.append(sbs.numpy()[:len(batch)])
    np.testing.assert_array_equal(got, np.concatenate(want)[discard_first:])


def test_cli_drive_recipe_on_cpu(tmp_path):
    """The verify recipe through the port's CLI: 14 frames of 64x48 ->
    three subclips and a 128x48 SBS output."""
    cv2 = pytest.importorskip("cv2")
    from vr_video_generator_tpu_torch.cli import main

    src = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    rng = np.random.default_rng(7)
    for i in range(14):
        f = np.full((48, 64, 3), i * 9 % 256, np.uint8)
        f[:, :20] = rng.integers(0, 255, 3, dtype=np.uint8)
        w.write(f[:, :, ::-1])
    w.release()
    out = str(tmp_path / "out.mkv")
    assert main(["--device", "cpu", "--mlp_fused", "xla", "--tail", "xla",
                 "--VideoDir", src, "--OutputDir", out,
                 "--DebugDir", str(tmp_path / "Debug") + "/",
                 "--SubClipDir", str(tmp_path / "Subclip") + "/",
                 "--Max_Frame_Count", "6", "--batch_size", "4",
                 "--input_size", "56", "--compute_dtype", "float32",
                 "--allow_random_weights"]) == 0
    assert sorted(os.listdir(tmp_path / "Subclip")) == ["0_5.mp4", "12_13.mp4",
                                                        "6_11.mp4"]
    assert os.path.exists(tmp_path / "Debug" / "segment_0.txt")
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 14
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.shape == (48, 128, 3)


def test_range_with_warm_up_continues_the_full_run(pipe, tmp_path):
    """convert_range from frame 6 with a 6-frame halo warm-up writes the same
    SBS frames as a run from frame 0 (the primed state removes the segment
    reset); both encodes decode to equal frames."""
    import dataclasses

    cv2 = pytest.importorskip("cv2")
    from vr_video_generator_tpu_torch.runtime.orchestrator import convert_range

    src = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (W, H))
    rng = np.random.default_rng(3)
    for _ in range(14):
        w.write(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    w.release()
    clips = {}
    for tag, begin in (("full", 0), ("range", 6)):
        cfg = dataclasses.replace(
            CFG, video_dir=src, max_frame_count=6, warmup_frames=6,
            subclip_dir=str(tmp_path / tag) + "/",
            debug_dir=str(tmp_path / f"debug_{tag}") + "/",
            writer_backend="cv2", reader_backend="cv2")
        assert convert_range(cfg, begin, 14, pipeline=pipe) == 14 - begin
        cap = cv2.VideoCapture(str(tmp_path / tag / "6_11.mp4"))
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f)
        cap.release()
        clips[tag] = np.stack(frames)
    assert clips["full"].shape == (6, H, 2 * W, 3)
    np.testing.assert_array_equal(clips["range"], clips["full"])


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present; the refusal is for machines "
                    "without one")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        SbsPipeline.create(CFG, H, W, allow_random=True, device="cuda")


@pytest.mark.parametrize("field,value,item", [
    ("depth_stride", 2, "depth_stride"), ("chunk_batches", 2, "step_many"),
    ("sbs_output", "packed", "packed SBS"), ("preprocess", "folded", "folded"),
    ("mlp_fused", "fused", "fused ViT"), ("tail", "fused", "fused DPT tail"),
    ("gelu", "tanh", "UI impl switches"),
])
def test_unported_run_options_raise(field, value, item):
    import dataclasses

    with pytest.raises(NotImplementedError, match=item):
        check_supported(dataclasses.replace(CFG, **{field: value}))


@pytest.mark.parametrize("argv,item", [
    (["--mesh", "2x1"], "multi-GPU"),
    (["--profile_dir", "trace"], "profiling"),
    (["--repair_mode", "1"], "repair modes 1 and 3"),
    (["--repair_mode", "3"], "repair modes 1 and 3"),
])
def test_unported_cli_options_raise(argv, item, tmp_path):
    from vr_video_generator_tpu_torch.cli import main

    dirs = ["--DebugDir", str(tmp_path / "D") + "/",
            "--SubClipDir", str(tmp_path / "S") + "/"]
    with pytest.raises(NotImplementedError, match=item):
        main(["--device", "cpu", *dirs, *argv])


def test_unported_entry_points_raise(pipe, frames):
    from vr_video_generator_tpu_torch.models.dinov2 import \
        DinoVisionTransformer
    from vr_video_generator_tpu_torch.ops.preprocess import preprocess_frames

    with pytest.raises(NotImplementedError, match="step_many"):
        pipe.step_many(frames[None, :BATCH], pipe.initial_state())
    with pytest.raises(NotImplementedError, match="folded"):
        preprocess_frames(torch.zeros(1, H, W, 3, dtype=torch.uint8),
                          (56, 70), impl="folded")
    with pytest.raises(NotImplementedError, match="vitg"):
        DinoVisionTransformer(ModelConfig.for_encoder("vitg"))


def test_port_imports_no_jax():
    code = ("import sys; import vr_video_generator_tpu_torch.cli, "
            "vr_video_generator_tpu_torch.pipeline, "
            "vr_video_generator_tpu_torch.runtime.segment, "
            "vr_video_generator_tpu_torch.runtime.orchestrator; "
            "bad = [m for m in ('jax', 'flax', 'cv2') if m in sys.modules]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
