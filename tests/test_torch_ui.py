"""PyTorch port: the front ends ``ui.app`` and ``ui.tkapp`` (the
counterparts of vr_video_generator_tpu/ui/) on the CPU, headless: every
case of tests/test_tkapp.py against the port's FormModel, the commands the
forms build against the JAX package's and the port's parsers, the integrity
report against the JAX one on the same directories, the form's run on the
card by default (refused without one), the console loop, and the launch
counts a UI-started process writes."""

import json
import os
import subprocess
import sys
import time

import cv2
import numpy as np
import pytest

from vr_video_generator_tpu.ui import app as jax_app
from vr_video_generator_tpu.ui import tkapp as jax_tkapp
from vr_video_generator_tpu_torch import checktool, cli
from vr_video_generator_tpu_torch.kernels import COUNTS_DIR_ENV
from vr_video_generator_tpu_torch.ui import app
from vr_video_generator_tpu_torch.ui.tkapp import (ENCODER_ITEMS,
                                                   REPAIR_ITEMS, FormModel)
from vr_video_generator_tpu_torch.utils.logging import (overflow_path,
                                                        record_overflow)
from vr_video_generator_tpu_torch.video.writer import SubclipWriter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, FPS = 48, 64, 10.0


def write_synthetic_video(path, n_frames, h=H, w=W):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), FPS,
                             (w, h))
    for i in range(n_frames):
        writer.write(np.full((h, w, 3), (i * 20) % 256, np.uint8))
    writer.release()


def write_subclips(subdir, frames, starts):
    """Subclips of ``frames`` (SBS width) beginning at each of ``starts``."""
    writer = SubclipWriter(subdir, FPS, W, H, backend="cv2")
    bounds = list(starts) + [len(frames)]
    for lo, hi in zip(bounds, bounds[1:]):
        writer.write_clip(lo, list(frames[lo:hi]))
    writer.close()


def edited(fields):
    """A form a user changed: paths with spaces, another encoder, the
    stride, a blank field (left out of the command)."""
    out = dict(fields)
    out.update(VideoDir="/data/movie night.mp4", OutputDir="",
               encoder="vitb",
               encoder_path="/ckpt/depth_anything_v2_vitb.pth",
               offset_fg="0.03", batch_size="4", Max_Frame_Count="12",
               depth_stride="2", stride_audit_every="3", repair_mode="2",
               compute_dtype="float32", Num_Workers="")
    return out


FORMS = {"default": dict, "edited": edited}


# -- the cases of tests/test_tkapp.py, on the port's FormModel --------------

def test_defaults_and_preview_roundtrip():
    m = FormModel()
    assert m.fields["encoder"] == "vits"
    pv = m.preview()
    assert "--VideoDir" in pv and "--encoder vits" in pv
    # empty OutputDir is auto-derived in the preview (reference :100-104)
    assert "SBS input.mkv" in pv
    assert "vr_video_generator_tpu_torch.cli" in pv


def test_combo_label_value_mapping():
    m = FormModel()
    for label, value in ENCODER_ITEMS.items():
        m.set_encoder_item(label)
        assert m.fields["encoder"] == value
        assert m.encoder_label() == label
    for label, value in REPAIR_ITEMS.items():
        m.set_repair_item(label)
        assert m.fields["repair_mode"] == value
        assert m.repair_label() == label
    assert ENCODER_ITEMS == jax_tkapp.ENCODER_ITEMS
    assert REPAIR_ITEMS == jax_tkapp.REPAIR_ITEMS


def test_auto_output_and_validation():
    m = FormModel()
    m.set_field("VideoDir", "/data/movie night.mp4")
    assert m.auto_output() == "/data/SBS movie night.mkv"
    assert m.validate() is None
    m.set_field("batch_size", "eight")
    assert "batch_size" in m.validate()
    m.set_field("batch_size", "8")
    m.set_field("offset_fg", "big")
    assert "offset_fg" in m.validate()


def test_run_rejects_invalid_and_runs_valid(tmp_path):
    m = FormModel()
    m.set_field("batch_size", "nope")
    with pytest.raises(ValueError):
        m.run()
    # valid config: swap the command for a short sleep via PipelineProcess
    m.set_field("batch_size", "8")
    m.proc.start([sys.executable, "-c", "import time; time.sleep(30)"])
    assert m.running()
    assert m.proc.returncode() is None
    m.stop()
    time.sleep(0.1)
    assert not m.running()
    assert m.proc.returncode() is None


def test_debug_listing(tmp_path):
    m = FormModel()
    m.set_field("DebugDir", str(tmp_path))
    (tmp_path / "segment_0.txt").write_text("hi")
    (tmp_path / "ERROR.txt").write_text("boom")
    assert m.debug_listing() == ["ERROR.txt", "segment_0.txt"]
    m.set_field("DebugDir", str(tmp_path / "missing"))
    assert m.debug_listing() == []


def test_verify_report_ok_and_broken(tmp_path):
    """"Verify Integrity": OK tree, then a gapped tree with the suggested
    repair command."""
    m = FormModel()
    m.set_field("SubClipDir", str(tmp_path / "missing") + os.sep)
    assert "no subclip directory" in m.verify_report()

    video = tmp_path / "in.mp4"
    write_synthetic_video(video, 10)
    subdir = str(tmp_path / "sub") + os.sep
    frames = np.random.default_rng(0).integers(0, 256, (10, H, W, 3),
                                               dtype=np.uint8)
    write_subclips(subdir, frames, (0, 6))
    m.set_field("SubClipDir", subdir)
    m.set_field("VideoDir", str(video))
    report = m.verify_report()
    assert "2 subclips covering frames [0, 9]" in report
    assert "all subclips OK" in report
    assert "coverage complete: 10/10" in report

    os.remove(os.path.join(subdir, "0_5.mp4"))
    write_subclips(subdir, frames[:4], (0,))  # gap: frames 4-5 missing
    report = m.verify_report()
    assert "BAD continuity" in report
    assert "regenerate frames [4, 6)" in report
    assert "--repair_mode 1 --start_frame 4 --end_frame 6" in report
    assert "coverage: frames [0, 9] of 10" in report


def test_verify_report_survives_stray_files(tmp_path):
    """A leftover file that breaks the numeric subclip-name sort gives a
    readable report line, not a traceback out of the UI callback."""
    subdir = tmp_path / "sub"
    subdir.mkdir()
    (subdir / "backup4").write_bytes(b"")  # ends in '4': picked up by sort
    m = FormModel()
    m.set_field("SubClipDir", str(subdir))
    report = m.verify_report()
    assert "cannot parse subclip names" in report
    assert "expected" in report


def test_repair_command_targets_checktool_with_repair_on():
    m = FormModel()
    m.set_field("VideoDir", "/tmp/in.mp4")
    m.set_field("repair_mode", "0")  # form value must NOT leak into repair
    cmd = m.repair_command()
    assert "vr_video_generator_tpu_torch.checktool" in cmd
    assert "vr_video_generator_tpu_torch.cli" not in cmd
    assert "vr_video_generator_tpu.checktool" not in cmd
    assert cmd[cmd.index("--repair_mode") + 1] == "1"
    assert cmd[cmd.index("--VideoDir") + 1] == "/tmp/in.mp4"


def test_repair_validates_and_spawns(monkeypatch):
    m = FormModel()
    m.set_field("batch_size", "nope")
    with pytest.raises(ValueError):
        m.repair()
    m.set_field("batch_size", "8")
    started = []
    monkeypatch.setattr(m.proc, "start", started.append)
    m.repair()
    assert started and "vr_video_generator_tpu_torch.checktool" in started[0]


# -- the commands against the JAX package's and the port's parsers ----------

@pytest.mark.parametrize("form", sorted(FORMS))
def test_build_command_equals_the_jax_one_but_the_module(form):
    """The same field set and defaults as the JAX form, and the same argv
    but for the module the command runs."""
    assert app.DEFAULT_FIELDS == jax_app.DEFAULT_FIELDS
    fields = app._with_auto_output(FORMS[form](app.DEFAULT_FIELDS))
    ours, theirs = app.build_command(fields), jax_app.build_command(fields)
    assert ours[:2] == theirs[:2] == [sys.executable, "-m"]
    assert (ours[2], theirs[2]) == ("vr_video_generator_tpu_torch.cli",
                                    "vr_video_generator_tpu.cli")
    assert ours[3:] == theirs[3:]
    rep, jrep = app.repair_command(fields), jax_app.repair_command(fields)
    assert (rep[2], jrep[2]) == ("vr_video_generator_tpu_torch.checktool",
                                 "vr_video_generator_tpu.checktool")
    assert rep[3:] == jrep[3:]


@pytest.mark.parametrize("form", sorted(FORMS))
def test_build_command_parses_with_the_port_cli(form):
    """argv[3:] parses with the port's CLI parser and leaves nothing
    unknown; each field reaches its flag, and --device is the CLI's
    default, the card."""
    fields = app._with_auto_output(FORMS[form](app.DEFAULT_FIELDS))
    args, unknown = cli.build_parser().parse_known_args(
        app.build_command(fields)[3:])
    assert unknown == []
    assert args.device == "cuda"
    for key, value in fields.items():
        if value != "":
            assert str(getattr(args, key)) == str(type(getattr(args, key))(
                value)), key
    cfg, _ = cli.parse_run_config(app.build_command(fields)[3:])
    assert cfg.encoder == fields["encoder"]
    assert cfg.depth_stride == int(fields["depth_stride"])


@pytest.mark.parametrize("form", sorted(FORMS))
def test_repair_command_parses_with_the_port_checktool(form):
    """The repair command runs the port's checktool, whose parser takes its
    own flags (repair on) and hands the rest to the CLI's, which leaves
    nothing unknown."""
    fields = FORMS[form](app.DEFAULT_FIELDS)
    argv = app.repair_command(fields)
    assert argv[:3] == [sys.executable, "-m",
                        "vr_video_generator_tpu_torch.checktool"]
    own, rest = checktool.build_parser().parse_known_args(argv[3:])
    assert own.repair_mode == 1
    assert own.SubClipDir == fields["SubClipDir"]
    args, unknown = cli.build_parser().parse_known_args(rest)
    assert unknown == []
    assert args.VideoDir == fields["VideoDir"]
    assert args.OutputDir == app.auto_output_name(fields["VideoDir"])


# -- the integrity report against the JAX one --------------------------------

@pytest.mark.parametrize("state", ["clean", "broken", "overflow"])
def test_integrity_report_equals_the_jax_one(tmp_path, state):
    """On the same subclip directory, the port's report is the JAX one's
    text: a clean tree, one with a short clip and a gap, and a clean tree
    whose debug dir holds depth-overflow records."""
    video = tmp_path / "in.mp4"
    write_synthetic_video(video, 12)
    subdir = str(tmp_path / "sub") + os.sep
    frames = np.random.default_rng(1).integers(0, 256, (12, H, W, 3),
                                               dtype=np.uint8)
    debug = str(tmp_path / "dbg")
    write_subclips(subdir, frames, (0, 4, 9))
    if state == "broken":
        # 4_8.mp4 truncated to 3 of its 5 frames; 9_11.mp4 lost
        short = os.path.join(subdir, "short.mp4")
        write_synthetic_video(short, 3, w=2 * W)
        os.replace(short, os.path.join(subdir, "4_8.mp4"))
        os.remove(os.path.join(subdir, "9_11.mp4"))
    if state == "overflow":
        record_overflow(overflow_path(debug), 0, 5, 3)
        record_overflow(overflow_path(debug), 9, 12, 2)
    ours = app.integrity_report(subdir, str(video), debug_dir=debug)
    theirs = jax_app.integrity_report(subdir, str(video), debug_dir=debug)
    assert ours == theirs
    assert ("all subclips OK" in ours) == (state != "broken")
    if state == "broken":
        assert "BAD length: 4_8.mp4 -> regenerate frames [4, 9)" in ours
        assert "coverage: frames [0, 8] of 12" in ours
    assert ("limit_step_cap on 5 frame(s)" in ours) == (state == "overflow")


# -- on the card by default ---------------------------------------------------

def test_form_run_goes_to_the_card_and_refuses_without_one(tmp_path, capfd,
                                                           monkeypatch):
    """The form's Run starts the port's CLI with no --device: the CLI runs
    on the card by default, so without one the run exits non-zero with the
    refusal, and writes no subclip (nothing falls back to the CPU)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("shows the refusal on a machine without a GPU")
    video = tmp_path / "in.mp4"
    write_synthetic_video(video, 6)
    m = FormModel()
    m.set_field("VideoDir", str(video))
    m.set_field("DebugDir", str(tmp_path / "D") + os.sep)
    m.set_field("SubClipDir", str(tmp_path / "S") + os.sep)
    m.set_field("encoder_path", str(tmp_path / "missing.pth"))
    assert "--device" not in m.preview()
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    m.run()
    t0 = time.time()
    while m.running() and time.time() - t0 < 120:
        time.sleep(0.2)
    assert not m.running()
    assert m.proc.returncode() not in (None, 0)
    err = capfd.readouterr().err
    assert "no CUDA GPU" in err, err[-2000:]
    assert not any((tmp_path / "S").glob("*.mp4"))


def test_console_app_shows_the_port_command(tmp_path):
    """The console loop: set, show (the preview runs the port's CLI),
    verify (the integrity report), an unknown field, quit."""
    subdir = str(tmp_path / "sub") + os.sep
    frames = np.zeros((6, H, W, 3), np.uint8)
    write_subclips(subdir, frames, (0,))
    feed = iter([f"set SubClipDir {subdir}", "set nosuch 1", "show",
                 "verify", "quit"])
    out = []
    app.run_app(input_fn=lambda _: next(feed), print_fn=out.append)
    text = "\n".join(out)
    assert "unknown field 'nosuch'" in text
    assert "-m vr_video_generator_tpu_torch.cli" in text
    assert f"  SubClipDir = {subdir}" in text
    assert "1 subclips covering frames [0, 5]" in text


def test_a_started_process_writes_its_launch_counts(tmp_path):
    """With VRVG_LAUNCH_COUNTS_DIR set, a process that imports the kernels
    writes its argv and non-zero launch counts there when it exits (how a
    caller counts the launches of a UI run); without it, nothing."""
    code = ("import vr_video_generator_tpu_torch.kernels as k; "
            "k.counter('warp_composite').count += 3; k.counter('idle')")
    env = dict(os.environ, PYTHONPATH=ROOT)
    env[COUNTS_DIR_ENV] = str(tmp_path)
    subprocess.run([sys.executable, "-c", code, "arg"], env=env, check=True)
    files = list(tmp_path.glob("launch_counts_*.json"))
    assert len(files) == 1
    rec = json.loads(files[0].read_text())
    assert rec["counts"] == {"warp_composite": 3}
    assert rec["argv"] == ["-c", "arg"]
    del env[COUNTS_DIR_ENV]
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   cwd=tmp_path)
    assert len(list(tmp_path.glob("launch_counts_*.json"))) == 1
