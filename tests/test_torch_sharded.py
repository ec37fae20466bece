"""PyTorch port: the data axis on the CPU. make_mesh, ShardedSbsPipeline
(two ``cpu`` slots) against the JAX package's ShardedSbsPipeline on 2 of
the 8 virtual CPU devices and against two port SbsPipelines, the sharded
runner's partition, warm-up, absolute anchor grid, overflow diagnostic and
failure modes against the JAX runner's contracts
(tests/test_sharded_runner.py), and the CLI's --mesh."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline import TINY, H, W
from tests.test_video import write_synthetic_video
from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.depth_anything_v2 import (
    DepthAnythingV2 as JaxDepthAnythingV2)
from vr_video_generator_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vr_video_generator_tpu.parallel.sharded import (
    ShardedSbsPipeline as JaxShardedSbsPipeline)
from vr_video_generator_tpu.runtime import sharded_runner as jax_runner
from vr_video_generator_tpu.utils.config import RunConfig
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.parallel.mesh import make_mesh
from vr_video_generator_tpu_torch.parallel.sharded import (
    ShardedSbsPipeline, batched_initial_state)
from vr_video_generator_tpu_torch.pipeline import SbsPipeline
from vr_video_generator_tpu_torch.runtime import orchestrator
from vr_video_generator_tpu_torch.runtime import sharded_runner as runner
from vr_video_generator_tpu_torch.runtime.segment import process_segment
from vr_video_generator_tpu_torch.utils.logging import WorkerLog
from vr_video_generator_tpu_torch.video import reader as port_reader
from vr_video_generator_tpu_torch.video import writer as port_writer
from vr_video_generator_tpu_torch.video.reader import VideoReader

torch.set_num_threads(2)

CFG = RunConfig(batch_size=2, input_size=56, compute_dtype="float32")
# State fields compared with the JAX package's: f32 depth differs by an
# f32 ulp or so (the forward's sums in another order), so the depth
# carries are held within 1e-4 of their peak and the offset range to 1e-5
# relative; the flags and counts exactly.
DEPTH_REL = 1e-4


@pytest.fixture(scope="module")
def weights():
    return random_state_dict(TINY, seed=16)


@pytest.fixture(scope="module")
def model(weights):
    return build_model(TINY, weights, torch.float32, "cpu")


@pytest.fixture(scope="module")
def jax_model(weights):
    return (JaxDepthAnythingV2(TINY, dtype=jnp.float32),
            jax.tree.map(jnp.asarray, convert_state_dict(weights, TINY)))


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = tmp_path_factory.mktemp("video") / "in.mp4"
    write_synthetic_video(path, 22, h=H, w=W)
    with VideoReader(str(path), begin=0) as r:
        frames = np.stack(list(r.frames(0, 22)))
    return str(path), frames


def cpu_mesh(n):
    return make_mesh((n, 1), devices=["cpu"] * n)


def sharded(model, n, **kw):
    return ShardedSbsPipeline(model, H, W, cpu_mesh(n),
                              run_cfg=dataclasses.replace(CFG, **kw))


class Capture:
    """A SubclipWriter stand-in that keeps the raw frames (no codec)."""

    def __init__(self, clips):
        self.clips = clips

    def __call__(self, *a, **k):
        return self

    def write_clip(self, begin, frames):
        self.clips[begin] = np.stack(frames)

    def wait(self):
        pass

    def close(self):
        pass


@pytest.fixture
def captured(monkeypatch):
    clips = {}
    monkeypatch.setattr(port_writer, "SubclipWriter", Capture(clips))
    return clips


def frames_of(clips):
    return np.concatenate([clips[k] for k in sorted(clips)])


# --------------------------------------------------------------- the mesh

def test_make_mesh_shapes():
    mesh = make_mesh((2, 1), devices=["cpu", "cpu"])
    assert mesh.shape == {"data": 2, "model": 1}
    assert mesh.data_devices == [torch.device("cpu")] * 2
    assert make_mesh(None, devices=["cpu"] * 3).shape["data"] == 3
    assert make_mesh((1, 1), device="cpu").data_devices == [
        torch.device("cpu")]
    with pytest.raises(ValueError, match="!= 3 devices"):
        make_mesh((2, 1), devices=["cpu"] * 3)


def test_make_mesh_refuses_the_model_axis_and_a_missing_card():
    with pytest.raises(NotImplementedError, match="model axis"):
        make_mesh((1, 2), devices=["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make_mesh((1, 1))


# ------------------------------------------------------- the partition

@pytest.mark.parametrize("start,end", [(0, 100), (0, 10), (5, 7), (3, 50),
                                       (17, 23)])
@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_partition_segments_matches_jax(start, end, n):
    for stride in (1, 2, 4):
        assert runner.partition_segments(start, end, n, stride) == \
            jax_runner.partition_segments(start, end, n, stride)


def test_partition_matches_reference_policy():
    assert runner.partition_segments(0, 100, 4) == [(0, 25), (25, 50),
                                                    (50, 75), (75, 100)]
    assert runner.partition_segments(5, 7, 4) == [(5, 6), (6, 7), (7, 7),
                                                  (7, 7)]


# -------------------------------------------------- the sharded pipeline

def test_replicas_hold_their_own_weights(model):
    sp = sharded(model, 2)
    ptrs = {next(r.model.parameters()).data_ptr() for r in sp.replicas}
    assert len(ptrs) == 2
    assert next(model.parameters()).data_ptr() not in ptrs
    assert sp.local_slots == [0, 1]
    states = sp.initial_state()
    assert len(states) == 2 and states[0].anchor_prev is None
    assert batched_initial_state(2, H, W, 2)[1].anchor_prev.shape == (H, W)


@pytest.mark.parametrize("stride", [1, 2])
def test_sharded_matches_two_sbs_pipelines(model, video, stride):
    """Each slot equals an SbsPipeline over the slot's own frames at the
    same batch, SBS and every state field, bit for bit, over two steps."""
    _, frames = video
    sp = sharded(model, 2, depth_stride=stride)
    singles = [SbsPipeline(model, H, W, run_cfg=sp.run_cfg) for _ in range(2)]
    states = sp.initial_state()
    want_states = [p.initial_state() for p in singles]
    for k in range(2):
        batch = frames[4 * k:4 * k + 4]
        sbs, states = sp.step(batch, states)
        for i, p in enumerate(singles):
            want, want_states[i] = p.step(batch[2 * i:2 * i + 2],
                                          want_states[i])
            np.testing.assert_array_equal(sbs[i].numpy(), want.numpy())
            for got, exp in zip(states[i], want_states[i]):
                assert (got is None and exp is None) or torch.equal(got, exp)


def _assert_state_close(got, want):
    """A port slot's state against the JAX package's slot (DEPTH_REL)."""
    for field in ("d_prev1", "d_prev2", "anchor_prev"):
        g, w = getattr(got, field), getattr(want, field)
        if w is None:
            assert g is None
            continue
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= DEPTH_REL * max(
            np.abs(w).max(), 1e-6), field
    np.testing.assert_allclose(got.offset_range.numpy(),
                               np.asarray(want.offset_range), rtol=1e-5)
    assert bool(got.has_state) == bool(want.has_state)
    assert int(got.overflow) == int(want.overflow)


def _jax_slot(states, i):
    return jax.tree.map(lambda a: a[i], states)


@pytest.mark.parametrize("stride", [1, 2])
def test_sharded_matches_jax_sharded(model, jax_model, video, stride):
    """The 2 x 1 pipeline against the JAX package's on 2 of the 8 virtual
    CPU devices, two steps: each slot's state field by field (DEPTH_REL),
    the right half equal to the input, the left half equal on >= 99.9% of
    pixels (an f32 ulp of depth can move a pixel across a band edge)."""
    _, frames = video
    jmodel, jparams = jax_model
    cfg = dataclasses.replace(CFG, depth_stride=stride)
    jsp = JaxShardedSbsPipeline(
        jmodel, jparams, H, W, jax_make_mesh((2, 1),
                                             devices=jax.devices()[:2]),
        run_cfg=cfg)
    sp = sharded(model, 2, depth_stride=stride)
    states, jstates = sp.initial_state(), jsp.initial_state()
    for k in range(2):
        batch = frames[4 * k:4 * k + 4]
        sbs, states = sp.step(batch, states)
        jsbs, jstates = jsp.step(batch, jstates)
        ours = torch.cat(sbs).numpy()
        jsbs = np.asarray(jsbs)
        np.testing.assert_array_equal(ours[:, :, W:], batch)
        same = np.all(ours[:, :, :W] == jsbs[:, :, :W], axis=-1).mean()
        assert same >= 0.999, f"step {k}: {same:.5f} of left pixels equal"
        for i in range(2):
            _assert_state_close(states[i], _jax_slot(jstates, i))


def test_stride_audit_matches_sbs_pipeline(model, video):
    """The per-slot audit equals each slot's SbsPipeline.stride_audit, and
    leaves the states as they were; at stride 1 it raises."""
    _, frames = video
    sp = sharded(model, 2, depth_stride=2)
    singles = [SbsPipeline(r.model, H, W, run_cfg=sp.run_cfg)
               for r in sp.replicas]
    _, states = sp.step(frames[:4], sp.initial_state())
    keep = [st.map(torch.clone) for st in states]
    stats = sp.stride_audit(frames[4:8], states)
    assert stats == sp.stride_audit_local(frames[4:8], states)
    for i, p in enumerate(singles):
        assert stats[i] == p.stride_audit(frames[4 + 2 * i:6 + 2 * i],
                                          states[i])
        assert all(torch.equal(a, b) for a, b in zip(states[i], keep[i]))
    with pytest.raises(ValueError, match="depth_stride > 1"):
        sharded(model, 2).stride_audit(frames[:4], states)


def test_sharded_packed_emit_is_loud_without_pallas(model):
    """--sbs_output packed reaches each slot's warp: on the plain warp impl
    that is the JAX package's ValueError."""
    sp = ShardedSbsPipeline(model, H, W, cpu_mesh(2), run_cfg=dataclasses.
                            replace(CFG, sbs_output="packed", warp_impl="xla"))
    assert sp.sbs_emit == "packed"
    with pytest.raises(ValueError, match="packed"):
        sp.step(np.zeros((4, H, W, 3), np.uint8), sp.initial_state())


# ------------------------------------------------------------- warm-up

@pytest.mark.parametrize("begins,warmup,stride", [
    ([4, 9], 3, 1),     # warmup not a multiple of the batch
    ([2, 9], 4, 2),     # begin < warmup at stride 2: the pads prime anchors
    ([0, 6], 4, 2),     # a slot with begin 0 at stride 2: reset cold
])
def test_primed_states_match_primed_state(model, video, begins, warmup,
                                          stride):
    """Each slot's warm-up equals SbsPipeline.primed_state on its preceding
    frames with min_batches = ceil(warmup / b), bit for bit; a slot with
    begin 0 is the cold state."""
    path, frames = video
    sp = sharded(model, 2, depth_stride=stride)
    states = runner._primed_states(sp, begins, path, 2, warmup, "cv2")
    single = SbsPipeline(model, H, W, run_cfg=sp.run_cfg)
    for i, lo in enumerate(begins):
        wu = max(0, lo - warmup)
        ref = single.primed_state(frames[wu:lo], 2,
                                  min_batches=-(-warmup // 2))
        if lo == 0:
            ref = single.initial_state()
        for got, want in zip(states[i], ref):
            assert (got is None and want is None) or torch.equal(got, want)


@pytest.mark.parametrize("begins,warmup,stride", [([4, 9], 3, 1),
                                                  ([0, 6], 4, 2)])
def test_primed_states_match_jax(model, jax_model, video, begins, warmup,
                                 stride):
    """The same warm-up against the JAX runner's _primed_states on its
    2 x 1 mesh, slot by slot (DEPTH_REL), the begin-0 slot at stride 2
    reset to the cold state in both."""
    path, _ = video
    jmodel, jparams = jax_model
    cfg = dataclasses.replace(CFG, depth_stride=stride)
    jsp = JaxShardedSbsPipeline(
        jmodel, jparams, H, W, jax_make_mesh((2, 1),
                                             devices=jax.devices()[:2]),
        run_cfg=cfg)
    jstates = jax_runner._primed_states(jsp, begins, path, b=2,
                                        warmup=warmup, reader_backend="cv2",
                                        multi_host=False, any_preceding=True,
                                        global_begins=begins)
    states = runner._primed_states(sharded(model, 2, depth_stride=stride),
                                   begins, path, 2, warmup, "cv2")
    for i in range(2):
        _assert_state_close(states[i], _jax_slot(jstates, i))


# ------------------------------------------------------------- the runner

def _oracle(model, frames, bounds, **kw):
    """Each segment through the single-device loop, cold: the reference's
    per-worker semantics."""
    clips = {}
    pipe = SbsPipeline(model, H, W, run_cfg=dataclasses.replace(CFG, **kw))

    class Reader:
        def __init__(self, lo):
            self.height, self.width, self.pos = H, W, lo

        def read_into(self, out):
            out[...] = frames[self.pos]
            self.pos += 1
            return True

    for lo, hi in bounds:
        if hi > lo:
            process_segment(pipe, Reader(lo), Capture(clips), lo, hi,
                            max_frame_count=4, batch_size=2)
    return clips


def test_run_sharded_matches_single_device(model, video, captured):
    """Four slots over 22 frames (the JAX runner's test), no warm-up: the
    subclips equal the per-segment single-device oracle's, bit for bit."""
    path, frames = video
    n = runner.run_sharded(sharded(model, 4), path, "unused/", 0, 22,
                           max_frame_count=4, batch_size=2,
                           reader_backend="cv2")
    assert n == 22
    want = _oracle(model, frames, runner.partition_segments(0, 22, 4))
    assert sorted(captured) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(captured[k], want[k])


def test_run_sharded_with_warmup_equals_one_sequential_run(model, video,
                                                           captured):
    """A warm-up covering every slot's prefix makes the sharded output one
    uninterrupted sequential run's (the port's CPU forward is row-identical
    at any batch composition)."""
    path, frames = video
    n = runner.run_sharded(sharded(model, 4), path, "unused/", 0, 16,
                           max_frame_count=4, batch_size=2,
                           reader_backend="cv2", warmup=12)
    assert n == 16
    pipe = SbsPipeline(model, H, W, run_cfg=CFG)
    st, want = pipe.initial_state(), []
    for i in range(0, 16, 2):
        sbs, st = pipe.step(frames[i:i + 2], st)
        want.append(sbs.numpy())
    np.testing.assert_array_equal(frames_of(captured), np.concatenate(want))


def test_run_sharded_unaligned_start_keeps_absolute_anchor_grid(
        model, video, captured):
    """depth_stride 2 from frame 1 (slots [1, 7) and [7, 13), both begins
    off the grid): bit for bit one cold sequential strided run's frames
    1..12."""
    path, frames = video
    pipe = SbsPipeline(model, H, W, run_cfg=dataclasses.replace(
        CFG, depth_stride=2))
    st, outs = pipe.initial_state(), []
    for i in range(0, 14, 2):
        sbs, st = pipe.step(frames[i:i + 2], st)
        outs.append(sbs.numpy())
    n = runner.run_sharded(sharded(model, 2, depth_stride=2), path,
                           "unused/", 1, 13, max_frame_count=4, batch_size=2,
                           reader_backend="cv2", warmup=6)
    assert n == 12
    np.testing.assert_array_equal(frames_of(captured),
                                  np.concatenate(outs)[1:13])


def test_run_sharded_empty_tail_slots(model, video, captured):
    """More slots than frames: the empty slots decode nothing and write
    nothing; the frames are the oracle's."""
    path, frames = video
    n = runner.run_sharded(sharded(model, 4), path, "unused/", 5, 7,
                           max_frame_count=4, batch_size=2,
                           reader_backend="cv2")
    assert n == 2 and sorted(captured) == [5, 6]
    want = _oracle(model, frames, [(5, 6), (6, 7)])
    for k in want:
        np.testing.assert_array_equal(captured[k], want[k])


def test_overflow_diagnostic_counts_only_real_frames(tmp_path, weights,
                                                     video):
    """A depth scaler that puts the last of 5 frames 5% over the cap: the
    sharded log reports exactly the real frames over it; the padded copies
    of the last frame and the empty slot count nothing (the JAX runner's
    test, 5 frames on 4 slots)."""
    path, frames = video
    cap = CFG.stereo().normalized().limit_step_cap
    raw = SbsPipeline(build_model(dataclasses.replace(TINY, depth_scaler=1.0),
                                  weights, torch.float32, "cpu"), H, W,
                      run_cfg=CFG).depth_only(frames[:5]).numpy()
    hot = dataclasses.replace(TINY, depth_scaler=1.05 * cap
                              / float(raw[4].max()))
    model = build_model(hot, weights, torch.float32, "cpu")
    single = SbsPipeline(model, H, W, run_cfg=CFG)
    over = single.depth_only(frames[:5]).numpy().max(axis=(1, 2)) > cap
    expected = int(over.sum())
    assert 1 <= expected < 5 and over[-1]
    log = tmp_path / "sharded.txt"
    n = runner.run_sharded(sharded(model, 4), path,
                           str(tmp_path / "S") + os.sep, 0, 5,
                           max_frame_count=4, batch_size=2,
                           writer_backend="cv2", reader_backend="cv2",
                           log=WorkerLog(str(log)),
                           overflow_path=str(tmp_path / "OVERFLOW.jsonl"))
    assert n == 5
    assert f"exceeded limit_step_cap on {expected} frames" in log.read_text()
    assert f'"overflow": {expected}' in (tmp_path / "OVERFLOW.jsonl"
                                         ).read_text()


def test_decoder_crash_raises(model, video, captured, monkeypatch):
    """A decoder that dies mid-run raises (chained to its error) instead
    of ending the run short."""
    path, _ = video
    real = VideoReader.frames

    def frames(self, begin, end):
        if begin >= 4:
            raise OSError("decoder died")
        yield from real(self, begin, end)

    monkeypatch.setattr(port_reader.VideoReader, "frames", frames)
    with pytest.raises(RuntimeError, match="decode thread crashed") as e:
        runner.run_sharded(sharded(model, 2), path, "unused/", 0, 16,
                           max_frame_count=4, batch_size=2,
                           reader_backend="cv2")
    assert isinstance(e.value.__cause__, OSError)


def test_failed_frame_read_becomes_black(model, video, captured,
                                         monkeypatch):
    """A frame the decoder cannot read is processed as a black frame; every
    output equals the oracle's on the video with that frame black."""
    import cv2

    path, frames = video
    bad = 3
    real = VideoReader.read

    def read(self):
        pos = int(self._cap.get(cv2.CAP_PROP_POS_FRAMES))
        out = real(self)
        return None if pos == bad else out

    monkeypatch.setattr(port_reader.VideoReader, "read", read)
    runner.run_sharded(sharded(model, 2), path, "unused/", 0, 8,
                       max_frame_count=4, batch_size=2, reader_backend="cv2")
    black = frames.copy()
    black[bad] = 0
    want = _oracle(model, black, [(0, 4), (4, 8)])
    assert sorted(captured) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(captured[k], want[k])


def test_stride_audit_lines_per_slot(tmp_path, model, video, captured):
    path, _ = video
    log = tmp_path / "log.txt"
    sp = sharded(model, 2, depth_stride=2, stride_audit_every=2)
    runner.run_sharded(sp, path, "unused/", 0, 12, max_frame_count=4,
                       batch_size=2, reader_backend="cv2",
                       log=WorkerLog(str(log)))
    lines = [ln for ln in log.read_text().splitlines()
             if ln.startswith("stride audit")]
    # slots [0, 6) and [6, 12), 3 steps, audits at steps 0 and 2
    assert [ln.split(":")[0] for ln in lines] == [
        "stride audit slot 0 frames [0, 2)",
        "stride audit slot 1 frames [6, 8)",
        "stride audit slot 0 frames [4, 6)",
        "stride audit slot 1 frames [10, 12)"]


def test_convert_range_refuses_a_sharded_pipeline(model, video, tmp_path):
    path, _ = video
    cfg = dataclasses.replace(CFG, video_dir=path,
                              debug_dir=str(tmp_path) + os.sep,
                              subclip_dir=str(tmp_path / "S") + os.sep)
    with pytest.raises(TypeError, match="single-device SbsPipeline"):
        orchestrator.convert_range(cfg, 0, 4, pipeline=sharded(model, 2),
                                   device="cpu")


# ------------------------------------------------------------------ CLI

def _cli_video(tmp_path, n=12):
    path = str(tmp_path / "in.mp4")
    write_synthetic_video(path, n)
    with VideoReader(path, begin=0) as r:
        return path, np.stack(list(r.frames(0, n)))


def test_cli_mesh_2x1_then_repair_mode_1(tmp_path, captured):
    """cli.main --mesh 2x1 --device cpu converts the video one segment per
    slot, each primed on its prefix: one sequential run's frames; then
    repair mode 1 of [4, 9) with --mesh re-renders exactly those frames,
    keeping the debug dir."""
    from vr_video_generator_tpu_torch import cli
    from vr_video_generator_tpu_torch import RunConfig as PortRunConfig

    path, frames = _cli_video(tmp_path)
    run = ["--device", "cpu", "--VideoDir", path,
           "--OutputDir", str(tmp_path / "o.mkv"),
           "--DebugDir", str(tmp_path / "D") + "/",
           "--SubClipDir", str(tmp_path / "S") + "/", "--batch_size", "2",
           "--input_size", "56", "--compute_dtype", "float32",
           "--Max_Frame_Count", "30", "--mlp_fused", "xla", "--tail", "xla",
           "--allow_random_weights", "--mesh", "2x1", "--repair_mode", "1"]
    assert cli.main(run) == 0
    assert sorted(captured) == [0, 6]
    cfg = PortRunConfig(batch_size=2, input_size=56, compute_dtype="float32",
                        mlp_fused="xla", tail="xla")
    pipe = SbsPipeline.create(cfg, 48, 64, allow_random=True, device="cpu")
    st, want = pipe.initial_state(), []
    for i in range(0, 12, 2):
        sbs, st = pipe.step(frames[i:i + 2], st)
        want.append(sbs.numpy())
    want = np.concatenate(want)
    np.testing.assert_array_equal(frames_of(captured), want)
    assert os.listdir(tmp_path / "D") == ["sharded_p0.txt"]
    captured.clear()
    assert cli.main([*run, "--start_frame", "4", "--end_frame", "9"]) == 0
    assert sorted(captured) == [4, 7]
    np.testing.assert_array_equal(frames_of(captured), want[4:9])
    assert os.listdir(tmp_path / "D") == ["sharded_p0.txt"]


def test_cli_mesh_writes_subclips_that_check(tmp_path):
    """--mesh 2x1 through the real writer (cv2): contiguous subclips that
    check clean, and combine into the full frame count."""
    from vr_video_generator_tpu_torch import cli
    from vr_video_generator_tpu_torch.video.check import check_subclips
    from vr_video_generator_tpu_torch.video.combine import sorted_subclips

    path, _ = _cli_video(tmp_path, 10)
    sub = str(tmp_path / "S") + "/"
    assert cli.main(["--device", "cpu", "--VideoDir", path,
                     "--OutputDir", str(tmp_path / "o.mkv"),
                     "--DebugDir", str(tmp_path / "D") + "/",
                     "--SubClipDir", sub, "--batch_size", "2",
                     "--input_size", "56", "--compute_dtype", "float32",
                     "--Max_Frame_Count", "3", "--mlp_fused", "xla",
                     "--tail", "xla", "--allow_random_weights",
                     "--mesh", "2x1", "--writer_backend", "cv2",
                     "--repair_mode", "1"]) == 0
    assert sorted_subclips(sub) == ["0_2.mp4", "3_4.mp4", "5_7.mp4",
                                    "8_9.mp4"]
    assert check_subclips(sub) == []


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "1x2"], "model axis"),
    (["--num_processes", "2"], "multi-host"),
    (["--coordinator_address", "localhost:1234"], "multi-host"),
])
def test_cli_unported_multi_device_options_raise(tmp_path, argv, match):
    from vr_video_generator_tpu_torch import cli

    with pytest.raises(NotImplementedError, match=match):
        cli.main(["--device", "cpu", "--DebugDir", str(tmp_path / "D") + "/",
                  "--SubClipDir", str(tmp_path / "S") + "/", *argv])


def test_bench_sharded_on_the_cpu():
    """bench --sharded 2x1 --device cpu: one line with the sharded metric
    and a device-resident rate, no host rate."""
    from vr_video_generator_tpu_torch import bench

    line = bench.run_sharded_config(2, (2, 1), device="cpu", steps=1, reps=1)
    assert line["metric"] == "torch_sbs_fps_270p_vits_sharded_mesh2x1"
    assert line["value"] > 0 and line["host_fps"] is None
    assert line["devices"] == ["cpu", "cpu"] and line["card"] is None
