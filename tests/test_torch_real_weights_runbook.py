"""PyTorch port: ``real_weights_runbook`` (the counterpart of
scripts/real_weights_runbook.py) on the CPU, with stand-in checkpoints saved
from the port's own seeded vits at full width: its constants and
calibration against the script's, the scaler decision, the drill end to
end, an off-family (wide-range) checkpoint, missing checkpoints, the
refusal without a card, and its golden raw depth against the JAX
package's f32 ``infer_depth`` on the same ``.pth``."""

import json
import os
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.depth_anything_v2 import \
    DepthAnythingV2 as JaxDepthAnythingV2
from vr_video_generator_tpu.models.depth_anything_v2 import \
    infer_depth as jax_infer_depth
from vr_video_generator_tpu.utils.config import DEPTH_SCALERS as JAX_SCALERS
from vr_video_generator_tpu.utils.config import ModelConfig as JModelConfig
from vr_video_generator_tpu_torch import __version__, real_weights_runbook
from vr_video_generator_tpu_torch.models.factory import random_state_dict
from vr_video_generator_tpu_torch.parity_report import FINAL_CONV
from vr_video_generator_tpu_torch.utils.config import (DEPTH_SCALERS,
                                                       ModelConfig,
                                                       StereoConfig)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from scripts import real_weights_runbook as script  # noqa: E402

torch.set_num_threads(2)

CAP = StereoConfig().limit_step_cap
INPUT = 126


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Two stand-in checkpoint dirs: the port's seeded vits state_dict at
    full width as saved tensors (``load_model`` reads with
    weights_only=True), and the same with the final head conv amplified as
    tests/test_real_weights_runbook.py does (weight x 50, bias |b| + 450),
    which puts raw depth far outside the family band."""
    root = tmp_path_factory.mktemp("checkpoints")
    sd = {k: torch.from_numpy(v) for k, v in
          random_state_dict(ModelConfig.for_encoder("vits")).items()}
    plain, wide = root / "plain", root / "wide"
    plain.mkdir()
    wide.mkdir()
    torch.save(sd, plain / "depth_anything_v2_vits.pth")
    sd[f"{FINAL_CONV}.weight"] = sd[f"{FINAL_CONV}.weight"] * 50.0
    sd[f"{FINAL_CONV}.bias"] = sd[f"{FINAL_CONV}.bias"].abs() + 450.0
    torch.save(sd, wide / "depth_anything_v2_vits.pth")
    return {"plain": plain, "wide": wide}


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = tmp_path_factory.mktemp("clip") / "tiny.mp4"
    rng = np.random.default_rng(11)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (128, 72))
    for _ in range(4):
        w.write(rng.integers(0, 255, (72, 128, 3), dtype=np.uint8))
    w.release()
    return path


def _run(tmp_path, ckpt_dir, configs, clip, monkeypatch):
    """The runbook on the CPU at input 126 on ``clip``, 2 frames; the
    parity subprocesses on 2 threads. Returns (rc, artifact)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    out = tmp_path / "REPORT.json"
    rc = real_weights_runbook.main(
        ["--checkpoints_dir", str(ckpt_dir), "--configs", configs,
         "--frames", "2", "--input_size", str(INPUT), "--video", str(clip),
         "--workdir", str(tmp_path / "work"), "--out", str(out),
         "--device", "cpu"])
    return rc, json.loads(out.read_text())


def test_configs_and_bands_equal_the_script():
    """CONFIGS and the bands are the script's; the target moves from the
    script's 13.0 to 13.5, between two integers (a departure), and stays
    inside the family band and under the step cap."""
    assert real_weights_runbook.CONFIGS == script.CONFIGS
    assert real_weights_runbook.EXPECTED_RAW_MAX == script.EXPECTED_RAW_MAX
    assert script.CAL_TARGET_MAX == 13.0
    assert real_weights_runbook.CAL_TARGET_MAX == 13.5
    assert real_weights_runbook.CAL_TARGET_MAX % 1 == 0.5
    assert 12.5 <= real_weights_runbook.CAL_TARGET_MAX <= 14.6 < CAP


@pytest.mark.parametrize("raw_max", [0.0, 0.5, 8.7, 17.0, 580.0, 4096.0])
def test_calibrate_scaler_equals_the_script(raw_max):
    """The same scaler as the JAX script's at either target, landing
    raw_max on the target under the step cap; a zero range does not divide
    by zero."""
    for target in (script.CAL_TARGET_MAX, real_weights_runbook.CAL_TARGET_MAX):
        s = real_weights_runbook.calibrate_scaler(raw_max, target)
        assert s == script.calibrate_scaler(raw_max, target)
        assert s > 0
        if raw_max:
            assert abs(raw_max * s - target) < 1e-9
            assert raw_max * s <= CAP
    assert real_weights_runbook.calibrate_scaler(raw_max) == \
        script.calibrate_scaler(raw_max, real_weights_runbook.CAL_TARGET_MAX)


@pytest.mark.parametrize("peak,moves", [(13.0, True), (13.5, False)])
def test_plane_tables_jump_at_an_integer_peak(peak, moves):
    """Why the target is 13.5: a frame whose blended depth peaks at 13.0
    and the same frame one ulp above it give different offset ranges and
    plane tables (ceil(max depth) goes from 13 to 14), while at 13.5 the
    ulp changes nothing."""
    from vr_video_generator_tpu_torch.ops.temporal import (TemporalState,
                                                           temporal_scan)
    from vr_video_generator_tpu_torch.ops.warp import (WarpSpec,
                                                       build_plane_tables)

    h, w = 72, 128
    depth = torch.from_numpy(np.random.default_rng(3).uniform(
        0.0, peak, (1, h, w)).astype(np.float32))
    depth[0, 10, 20] = peak
    up = depth.clone()
    up[0, 10, 20] = float(np.nextafter(np.float32(peak), np.float32(np.inf)))
    spec = WarpSpec.create(h, w, StereoConfig())
    tables = []
    for d in (depth, up):
        blended, ranges, _ = temporal_scan(d, TemporalState.initial(h, w),
                                           spec)
        tables.append(build_plane_tables(blended, ranges, spec.cfg, h,
                                         spec.max_planes))
    # steps past the last plane are inf - inf (NaN) on both sides
    same = [torch.equal(a.nan_to_num(), b.nan_to_num())
            for a, b in zip(*tables)]
    assert (not all(same)) == moves
    if moves:
        assert not torch.equal(tables[0].cutoffs, tables[1].cutoffs)
        assert not torch.equal(tables[0].offset_range,
                               tables[1].offset_range)


@pytest.mark.parametrize("encoder,raw_max,shipped,calibrated", [
    ("vits", 8.7, 1.618, False),      # in band, under the cap: shipped
    ("vits", 1.77, 1.618, True),      # below the band
    ("vitb", 27.0, 1.0, True),        # in band, shipped x raw over the cap
    ("vitg", 5.0, 0.5, True),         # no band: always calibrated
])
def test_scaler_decision(encoder, raw_max, shipped, calibrated):
    """The decision of scripts/real_weights_runbook.py:145-157, on four
    cases, with the scaler and scaled maximum that follow from it."""
    got = real_weights_runbook.scaler_decision(encoder, raw_max, shipped, CAP)
    family = script.EXPECTED_RAW_MAX[encoder]
    raw_range_ok = family is not None and family[0] <= raw_max <= family[1]
    want_cal = (not raw_range_ok) or (raw_max * shipped > CAP)
    target = real_weights_runbook.CAL_TARGET_MAX
    scaler = script.calibrate_scaler(raw_max, target) if want_cal else shipped
    assert got == {"calibrated": calibrated, "scaler_used": scaler,
                   "scaled_depth_max": raw_max * scaler,
                   "raw_range_ok": raw_range_ok,
                   "under_step_cap": raw_max * scaler <= CAP}
    assert got["calibrated"] == want_cal


def test_runbook_drill_passes_with_standin(tmp_path, checkpoints, clip,
                                           monkeypatch):
    """Configs 1 and 2 with the plain stand-in: one PASS row each, the
    golden depth and the parity gate passing."""
    rc, artifact = _run(tmp_path, checkpoints["plain"], "1,2", clip,
                        monkeypatch)
    assert rc == 0
    assert artifact["all_pass"] is True
    assert artifact["device"] == "cpu"
    assert artifact["compute_dtype"] == "float32"
    rows = artifact["rows"]
    assert [r["config"] for r in rows] == [1, 2]
    for row in rows:
        assert row["encoder"] == "vits"
        assert row["status"] == "PASS"
        g = row["golden_depth"]
        assert g["depth_ok"] and g["under_step_cap"]
        assert "PASS" in row["parity_tail"][-1]


def test_runbook_calibrates_wide_range_checkpoint(tmp_path, checkpoints, clip,
                                                  monkeypatch):
    """The amplified stand-in: the shipped scaler would exceed the step
    cap, so the scaler is calibrated onto the target, carried into the
    parity run, and the row passes."""
    rc, artifact = _run(tmp_path, checkpoints["wide"], "1", clip,
                        monkeypatch)
    assert rc == 0
    row = artifact["rows"][0]
    assert row["status"] == "PASS"
    g = row["golden_depth"]
    assert g["calibrated"] is True
    assert g["under_step_cap"] is True
    assert g["depth_ok"] is True
    assert g["raw_range_ok"] is False
    assert abs(g["raw_depth_max"] * g["scaler_used"]
               - real_weights_runbook.CAL_TARGET_MAX) < 1e-6
    assert g["raw_depth_max"] * g["shipped_scaler"] > CAP


def test_runbook_skips_missing_checkpoints(tmp_path, monkeypatch):
    """No checkpoint: SKIP rows, nothing proven, exit code 1."""
    rc, artifact = _run(tmp_path, tmp_path, "1,3", tmp_path / "none.mp4",
                        monkeypatch)
    assert rc == 1
    assert artifact["all_pass"] is False
    assert [r["status"] for r in artifact["rows"]] == \
        ["SKIP (checkpoint missing)"] * 2


def test_runbook_defaults_to_the_card():
    """--device defaults to cuda, and the parity dtype to bf16 there, f32
    on the CPU (the script's bf16 on tpu)."""
    args = real_weights_runbook.build_parser().parse_args([])
    assert args.device == "cuda"
    assert args.compute_dtype is None


def test_runbook_without_a_card_raises(tmp_path, checkpoints, clip,
                                       monkeypatch):
    """--device cuda with no card raises before any row, and nothing runs
    on the CPU in its place: no artifact is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "REPORT.json"
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        real_weights_runbook.main(
            ["--checkpoints_dir", str(checkpoints["wide"]), "--configs", "1",
             "--video", str(clip), "--out", str(out), "--device", "cuda",
             "--workdir", str(tmp_path / "work")])
    assert not out.exists()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        real_weights_runbook.depth_golden(
            "vits", str(checkpoints["wide"] / "depth_anything_v2_vits.pth"),
            str(clip), 1, INPUT, "cuda")


def test_golden_raw_max_equals_the_jax_package(checkpoints, clip):
    """On the same stand-in .pth at input 126, the golden step's raw depth
    maximum equals the JAX package's f32 infer_depth maximum (converted by
    models/convert.convert_state_dict, divided by the JAX scaler) within
    1e-4 relative."""
    ckpt = checkpoints["wide"] / "depth_anything_v2_vits.pth"
    golden = real_weights_runbook.depth_golden("vits", str(ckpt), str(clip),
                                               2, INPUT, "cpu")
    from vr_video_generator_tpu_torch.video.reader import VideoReader

    with VideoReader(str(clip)) as reader:
        frames = np.stack(list(reader.frames(0, 2)))
    jcfg = JModelConfig.for_encoder("vits")
    params = convert_state_dict(torch.load(ckpt, weights_only=True), jcfg)
    depth = np.asarray(jax_infer_depth(
        JaxDepthAnythingV2(jcfg, dtype=jnp.float32), params,
        jnp.asarray(frames), input_size=INPUT)) / JAX_SCALERS["vits"]
    jax_max = float(depth.max())
    assert JAX_SCALERS["vits"] == DEPTH_SCALERS["vits"]
    assert abs(golden["raw_depth_max"] - jax_max) <= 1e-4 * jax_max
    assert golden["calibrated"] and golden["depth_ok"]


def test_version_equals_the_jax_package():
    from vr_video_generator_tpu import __version__ as jax_version

    assert __version__ == jax_version
