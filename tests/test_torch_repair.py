"""PyTorch port: repair modes 1 and 3, the absolute stride anchor grid of
convert_range, check_and_repair, video/check.py and the checktool on the
CPU, against the contracts of tests/test_orchestrator.py and
tests/test_checktool.py and against the JAX package on the same videos.

The model, geometry and video are tests/test_orchestrator.py's. At stride
> 1 the warm-up's front pads are no fixed point (SbsPipeline.primed_state):
they change the blended depth of the first real frames after them, and
through it the offset range only where ceil(max depth) of those frames
moves. On this video (depth peaks 2-3) it does not, as on the JAX
package's, so a range whose warm-up reaches frame 0 renders the full run's
frames bit for bit."""

import dataclasses
import os
import shutil

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
from vr_video_generator_tpu.pipeline import SbsPipeline as JaxSbsPipeline
from vr_video_generator_tpu.runtime import orchestrator as jax_orchestrator
from vr_video_generator_tpu.utils.config import RunConfig
from vr_video_generator_tpu.video import check as jax_check
from vr_video_generator_tpu_torch import checktool
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.pipeline import SbsPipeline
from vr_video_generator_tpu_torch.runtime import orchestrator
from vr_video_generator_tpu_torch.video import check, writer as port_writer
from vr_video_generator_tpu_torch.video.combine import sorted_subclips
from vr_video_generator_tpu_torch.video.reader import VideoReader, probe_video

torch.set_num_threads(2)

N_FRAMES = 16


@pytest.fixture(scope="module")
def weights():
    return random_state_dict(TINY, seed=4)


@pytest.fixture(scope="module")
def model(weights):
    return build_model(TINY, weights, torch.float32, "cpu")


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = tmp_path_factory.mktemp("video") / "in.mp4"
    write_synthetic_video(path, N_FRAMES, h=H, w=W)
    with VideoReader(str(path), begin=0) as r:
        frames = np.stack(list(r.frames(0, N_FRAMES)))
    return str(path), frames


def base_cfg(video_path, tmp_path, **kw):
    os.makedirs(tmp_path / "Debug", exist_ok=True)
    return RunConfig(**{**dict(
        video_dir=video_path, output_dir=str(tmp_path / "out.mkv"),
        debug_dir=str(tmp_path / "Debug") + os.sep,
        subclip_dir=str(tmp_path / "Subclip") + os.sep, max_frame_count=4,
        batch_size=4, input_size=56, compute_dtype="float32"), **kw})


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


def sequential(pipe, frames, batch=4):
    """One cold run over the whole video, batch by batch: the oracle."""
    st, outs = pipe.initial_state(), []
    for i in range(0, len(frames), batch):
        sbs, st = pipe.step(frames[i:i + batch], st)
        outs.append(sbs.numpy())
    return np.concatenate(outs)


@pytest.fixture(scope="module")
def fulls(model, video):
    _, frames = video
    out = {}
    for s in (1, 2, 4):
        cfg = RunConfig(batch_size=4, input_size=56, compute_dtype="float32",
                        depth_stride=s)
        out[s] = (SbsPipeline(model, H, W, run_cfg=cfg),
                  sequential(SbsPipeline(model, H, W, run_cfg=cfg), frames))
    return out


# ------------------------------------------------------- convert and repair

def test_convert_range_and_repair(model, video, tmp_path):
    cfg = base_cfg(video[0], tmp_path)
    pipe = SbsPipeline(model, H, W, run_cfg=cfg)
    assert orchestrator.convert_range(cfg, 0, 12, pipeline=pipe) == 12
    assert sorted_subclips(cfg.subclip_dir) == ["0_3.mp4", "4_7.mp4",
                                                "8_11.mp4"]
    assert check.check_subclips(cfg.subclip_dir) == []
    os.remove(os.path.join(cfg.subclip_dir, "4_7.mp4"))
    issues = check.check_subclips(cfg.subclip_dir)
    assert len(issues) == 1 and issues[0].repair_range == (4, 8)
    orchestrator.convert_range(cfg, 4, 8, pipeline=pipe)
    assert check.check_subclips(cfg.subclip_dir) == []


def test_repair_heals_clip_truncated_by_worker_death(model, video, tmp_path):
    """A subclip left unreadable by a killed encode is a length issue:
    check_and_repair removes it and converts exactly its range again."""
    cfg = base_cfg(video[0], tmp_path)
    pipe = SbsPipeline(model, H, W, run_cfg=cfg)
    orchestrator.convert_range(cfg, 0, 12, pipeline=pipe)
    with open(os.path.join(cfg.subclip_dir, "4_7.mp4"), "wb") as f:
        f.write(b"\x00\x01partial-write-then-SIGKILL")
    issues = orchestrator.check_and_repair(cfg, repair=True, pipeline=pipe)
    assert [(i.kind, i.repair_range) for i in issues] == [("length", (4, 8))]
    assert check.check_subclips(cfg.subclip_dir) == []
    assert sorted_subclips(cfg.subclip_dir) == ["0_3.mp4", "4_7.mp4",
                                                "8_11.mp4"]


def test_check_and_repair_builds_one_pipeline_for_all_ranges(
        model, video, tmp_path, monkeypatch):
    """Without a pipeline, check_and_repair builds one, on the device it is
    given, at the first broken range and reuses it for every range."""
    cfg = base_cfg(video[0], tmp_path)
    pipe = SbsPipeline(model, H, W, run_cfg=cfg)
    orchestrator.convert_range(cfg, 0, 12, pipeline=pipe)
    with open(os.path.join(cfg.subclip_dir, "0_3.mp4"), "wb") as f:
        f.write(b"\x00corrupt")
    os.remove(os.path.join(cfg.subclip_dir, "4_7.mp4"))
    builds = []

    def create(cls, *a, **k):
        builds.append(k.get("device"))
        return pipe

    monkeypatch.setattr(SbsPipeline, "create", classmethod(create))
    issues = orchestrator.check_and_repair(cfg, repair=True,
                                           allow_random=True, device="cpu")
    assert len(issues) == 2 and builds == ["cpu"]
    assert check.check_subclips(cfg.subclip_dir) == []
    builds.clear()
    assert orchestrator.check_and_repair(cfg, repair=True) == []
    assert builds == []  # nothing broken: no pipeline built


# ------------------------------------------------ the absolute anchor grid

def test_repair_range_keeps_absolute_anchor_grid(video, tmp_path, captured,
                                                 fulls):
    """depth_stride 2: ranges beginning off the stride grid (5 and 9)
    render the full run's frames bit for bit: processing starts at the
    aligned frame and its leading outputs are dropped."""
    pipe, full = fulls[2]
    cfg = base_cfg(video[0], tmp_path, max_frame_count=16, depth_stride=2,
                   warmup_frames=4)
    assert orchestrator.convert_range(cfg, 5, 9, pipeline=pipe) == 4
    np.testing.assert_array_equal(captured[5], full[5:9])
    captured.clear()
    cfg2 = dataclasses.replace(cfg, warmup_frames=8)
    assert orchestrator.convert_range(cfg2, 9, 16, pipeline=pipe) == 7
    np.testing.assert_array_equal(captured[9], full[9:16])


@pytest.mark.parametrize("trial", range(6))
def test_random_range_stride_sweep(video, tmp_path, captured, fulls, trial):
    """Seeded (stride, begin, end, warm-up) draws, the warm-up covering the
    whole history: convert_range equals the slice of one cold sequential
    run bit for bit."""
    draw = np.random.default_rng(16 + trial)
    s = int(draw.choice([1, 2, 4]))
    begin = int(draw.integers(0, N_FRAMES - 1))
    end = int(draw.integers(begin + 1, N_FRAMES + 1))
    warm = begin + int(draw.integers(0, 5))
    pipe, full = fulls[s]
    cfg = base_cfg(video[0], tmp_path, max_frame_count=16, depth_stride=s,
                   warmup_frames=warm)
    assert orchestrator.convert_range(cfg, begin, end, pipeline=pipe) \
        == end - begin
    got = np.concatenate([captured[k] for k in sorted(captured)])
    np.testing.assert_array_equal(
        got, full[begin:end],
        err_msg=f"stride={s} [{begin},{end}) warm={warm}")


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_convert_range_matches_jax(weights, video, tmp_path, monkeypatch,
                                   stride):
    """The port's convert_range and the JAX package's over the same off-grid
    range [5, 15) with a 4-frame warm-up, on the same converted weights:
    the same frames written, in the same clips; the right half equal to
    the input, the left half equal on >= 99.9% of pixels (an f32 ulp of
    depth can move a pixel across a band edge)."""
    path, frames = video
    cfg = base_cfg(path, tmp_path, depth_stride=stride, warmup_frames=4)
    jmodel = JaxDepthAnythingV2(TINY, dtype=jnp.float32)
    jparams = jax.tree.map(jnp.asarray, convert_state_dict(weights, TINY))
    port_clips, jax_clips = {}, {}
    monkeypatch.setattr(port_writer, "SubclipWriter", Capture(port_clips))
    monkeypatch.setattr(jax_orchestrator, "SubclipWriter", Capture(jax_clips))
    pipe = SbsPipeline(build_model(TINY, weights, torch.float32, "cpu"), H, W,
                       run_cfg=cfg)
    jpipe = JaxSbsPipeline(jmodel, jparams, H, W, run_cfg=cfg)
    assert orchestrator.convert_range(cfg, 5, 15, pipeline=pipe) == 10
    assert jax_orchestrator.convert_range(cfg, 5, 15, pipeline=jpipe) == 10
    assert sorted(port_clips) == sorted(jax_clips) == [5, 9, 13]
    got = np.concatenate([port_clips[k] for k in sorted(port_clips)])
    want = np.concatenate([np.asarray(jax_clips[k]) for k in sorted(jax_clips)])
    np.testing.assert_array_equal(got[:, :, W:], frames[5:15])
    same = np.all(got[:, :, :W] == want[:, :, :W], axis=-1).mean()
    assert same >= 0.999, f"{same:.5f} of left pixels equal"


# ------------------------------------------------------------ repair modes

def test_repair_mode_1_keeps_debug_dir_and_does_not_combine(
        model, video, tmp_path, monkeypatch):
    """Mode 1 converts [start_frame, end_frame) into the subclip dir next to
    the clips already there, keeps the debug dir (the segment logs of the
    earlier run) and combines nothing."""
    from vr_video_generator_tpu_torch.video import combine

    cfg = base_cfg(video[0], tmp_path, start_frame=4, end_frame=8,
                   repair_mode=1)
    os.makedirs(cfg.subclip_dir)
    (tmp_path / "Debug" / "segment_0.txt").write_text("earlier run")
    monkeypatch.setattr(SbsPipeline, "create", classmethod(
        lambda cls, *a, **k: SbsPipeline(model, H, W, run_cfg=cfg)))
    monkeypatch.setattr(combine, "combine_clips", pytest.fail)
    orchestrator.run(cfg, allow_random=True, device="cpu")
    assert sorted_subclips(cfg.subclip_dir) == ["4_7.mp4"]
    assert sorted(os.listdir(tmp_path / "Debug")) == [
        "segment_0.txt", "segment_4.txt", "segment_4_profile.csv"]
    assert not os.path.exists(cfg.output_dir)


def test_repair_mode_3_combines_video_only(model, video, tmp_path,
                                           monkeypatch, capsys):
    """Mode 3 clears the debug dir and combines the existing subclips with
    just_combine=1 (video only, no audio), then checks the frame count."""
    from vr_video_generator_tpu_torch.video import combine

    cfg = base_cfg(video[0], tmp_path)
    orchestrator.convert_range(cfg, 0, N_FRAMES,
                               pipeline=SbsPipeline(model, H, W, run_cfg=cfg))
    calls = []
    real = combine.combine_clips

    def spy(*a, **k):
        calls.append(k.get("just_combine"))
        return real(*a, **k)

    monkeypatch.setattr(combine, "combine_clips", spy)
    orchestrator.run(dataclasses.replace(cfg, repair_mode=3),
                     allow_random=True, device="cpu")
    assert calls == [1]
    assert os.listdir(tmp_path / "Debug") == []
    _, n, w, h = probe_video(cfg.output_dir)
    assert (n, w, h) == (N_FRAMES, 2 * W, H)
    assert "Original: 16 output: 16, difference: 0" in capsys.readouterr().out


# ---------------------------------------------- video/check.py and checktool

def _damage(sub, kind):
    """Damage a copy of a 0_3 / 4_7 / 8_11 / 12_15 subclip dir."""
    if kind == "gap":
        os.remove(sub / "4_7.mp4")
    elif kind == "truncated":
        (sub / "8_11.mp4").write_bytes(b"not a video")
    elif kind == "overlap":
        shutil.copy(sub / "4_7.mp4", sub / "6_9.mp4")
        os.remove(sub / "8_11.mp4")
    elif kind == "contained":
        shutil.copy(sub / "4_7.mp4", sub / "5_6.mp4")
    elif kind == "short":
        shutil.copy(sub / "4_7.mp4", sub / "12_16.mp4")
        os.remove(sub / "12_15.mp4")


@pytest.fixture(scope="module")
def clean_subclips(model, video, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clean")
    cfg = base_cfg(video[0], tmp)
    orchestrator.convert_range(cfg, 0, N_FRAMES,
                               pipeline=SbsPipeline(model, H, W, run_cfg=cfg))
    return tmp / "Subclip"


@pytest.mark.parametrize("kind", ["clean", "gap", "truncated", "overlap",
                                  "contained", "short"])
def test_check_subclips_matches_jax(clean_subclips, tmp_path, kind):
    """The port's check_subclips and the JAX package's on copies of the
    same damaged subclip dir: the same issues, and with remove_bad the
    same clips left."""
    dirs = {}
    for side in ("port", "jax"):
        dirs[side] = tmp_path / side
        shutil.copytree(clean_subclips, dirs[side])
        _damage(dirs[side], kind)
    got = check.check_subclips(str(dirs["port"]), remove_bad=True)
    want = jax_check.check_subclips(str(dirs["jax"]), remove_bad=True)
    assert [(i.kind, i.filename, i.repair_range) for i in got] \
        == [(i.kind, i.filename, i.repair_range) for i in want]
    assert (got == []) == (kind == "clean")
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["jax"]))
    assert check.parse_clip_name("12_15.mp4") \
        == jax_check.parse_clip_name("12_15.mp4") == (12, 15)


def test_checktool_report_mode_lists_issues_without_touching_files(
        tmp_path, capsys):
    sub = tmp_path / "Subclip"
    sub.mkdir()
    write_synthetic_video(sub / "0_3.mp4", 4, h=48, w=64)
    write_synthetic_video(sub / "6_9.mp4", 4, h=48, w=64)  # gap at 4..5
    assert checktool.main(["--SubClipDir", str(sub)]) == 0
    out = capsys.readouterr().out
    assert "continuity issue" in out and "(4, 6)" in out
    assert sorted(os.listdir(sub)) == ["0_3.mp4", "6_9.mp4"]


def test_checktool_repair_mode_regenerates_broken_range(tmp_path, capsys):
    """A full conversion through the port's CLI flags, one subclip killed
    mid-write, then the checktool's repair mode on the CPU: the range is
    converted again and the check is clean."""
    from vr_video_generator_tpu_torch.cli import parse_run_config

    video = tmp_path / "in.mp4"
    write_synthetic_video(video, 8, h=70, w=126)
    sub, debug = tmp_path / "Subclip", tmp_path / "Debug"
    sub.mkdir()
    debug.mkdir()
    flags = ["--VideoDir", str(video), "--SubClipDir", str(sub) + os.sep,
             "--DebugDir", str(debug) + os.sep, "--Max_Frame_Count", "4",
             "--batch_size", "4", "--input_size", "56",
             "--compute_dtype", "float32", "--allow_random_weights",
             "--device", "cpu", "--depth_stride", "2"]
    cfg, _ = parse_run_config(flags)
    orchestrator.convert_range(cfg, 0, 8, allow_random=True, device="cpu")
    assert check.check_subclips(str(sub)) == []
    (sub / "4_7.mp4").write_bytes(b"not a video")
    assert checktool.main(["--SubClipDir", str(sub) + os.sep,
                           "--repair_mode", "1"] + flags) == 0
    assert "repaired 1 issue(s)" in capsys.readouterr().out
    assert check.check_subclips(str(sub)) == []
    assert (debug / "segment_4.txt").exists()
