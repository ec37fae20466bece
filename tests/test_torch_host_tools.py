"""PyTorch port: the host tooling on the CPU: ``host_io_bench`` (the
counterpart of scripts/host_io_bench.py), ``soak_gen`` and ``soak`` (of
scripts/soak_gen.py and scripts/soak.py), and each tool's refusal to run
on the CPU when the card it defaults to is missing."""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from vr_video_generator_tpu_torch import (host_io_bench, parity_report,
                                          perf_compare, soak, soak_gen)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_host_io_bench_small_rates_positive():
    """The four rates at 64 x 96 x 4 frames on the CPU staging batch: all
    positive, in the JAX script's lines, the requirement 2 x w x h x 3 x
    60 bytes a second."""
    lines = host_io_bench.report("cpu", h=64, w=96, n_frames=4, reps=2)
    assert lines[0].startswith("host: ") and "staging batch: numpy" in lines[0]
    assert lines[1].startswith("decode staging (BGR->RGB batch row, 96x64)")
    assert lines[2].startswith("encoder pipe (raw 96x64 SBS -> subprocess")
    rates = [float(tok) for ln in lines[1:3] for tok in ln.split()
             if tok.replace(".", "").isdigit() and "." in tok]
    assert len(rates) == 4 and all(r > 0 for r in rates[:2] + rates[2:])
    assert lines[3] == (f"96x64@60 SBS requirement: "
                        f"{2 * 96 * 64 * 3 * 60 / 1e9:.2f} GB/s sustained")


def test_host_io_encoder_pipe_writes_the_frames_byte_for_byte(tmp_path):
    """write_full (and the Python pipe before it) through ``cat > file``:
    the file holds the frames, byte for byte, once a repeat. The decode
    staging's native swizzle equals the numpy reversed slice."""
    from vr_video_generator_tpu_torch import native

    out = tmp_path / "pipe.bin"
    py, nat = host_io_bench.bench_encoder_pipe(64, 96, 4, 2,
                                               sink=f"cat > {out}")
    assert py > 0 and nat > 0
    frames = np.random.default_rng(0).integers(0, 256, (4, 64, 192, 3),
                                               dtype=np.uint8)
    assert out.read_bytes() == frames.tobytes() * 2
    batch = host_io_bench.staging_batch((1, 64, 96, 3), torch.device("cpu"))
    native.bgr_to_rgb(frames[0, :, :96], batch[0])
    np.testing.assert_array_equal(batch[0], frames[0, :, :96, ::-1])


def _clip(path, n, seed, rolling):
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (64, 48))
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (48, 128, 3), dtype=np.uint8)
    for i in range(n):
        w.write(np.ascontiguousarray(base[:, i % 64:i % 64 + 64]) if rolling
                else rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
    w.release()


def _run_soak(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, "-m", "vr_video_generator_tpu_torch.soak",
         "--device", "cpu", *args], capture_output=True, text=True,
        timeout=300, cwd=str(tmp_path), env=env)


def test_soak_cli_mode_on_cpu(tmp_path):
    """The CLI mode on a 24-frame 64 x 48 clip at input 56, f32, stride 2,
    B = 4, 8-frame subclips: PASS, with the artifact keys the JAX soak's
    test reads, through real encoder subprocesses."""
    video = tmp_path / "in.mp4"
    _clip(video, 24, 11, rolling=True)
    out = tmp_path / "SOAK_smoke.json"
    p = _run_soak(["--video", str(video), "--workdir", str(tmp_path / "work"),
                   "--out", str(out), "--depth_stride", "2",
                   "--batch_size", "4", "--max_frame_count", "8",
                   "--num_workers", "2", "--sample_every", "0.2",
                   "--input_size", "56", "--compute_dtype", "float32"],
                  tmp_path)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    assert "soak PASS" in p.stdout
    art = json.loads(out.read_text())
    assert art["rc"] == 0
    assert art["frames"] == 24
    assert art["checker_issues"] == []
    assert art["frame_count_diff"] == 0
    assert art["clip_fps"]["clips"] >= 1
    assert art["rss_mb"]["peak"] >= art["rss_mb"]["start"] > 0
    assert art["samples"], "sampler thread recorded nothing"
    assert "double" in art["encoder_io"] or "ffmpeg" in art["encoder_io"]
    assert art["device"] == "cpu"
    assert art["device_mb"]["available"] is False


def test_soak_device_only_on_cpu(tmp_path):
    """--device_only 200 on the CPU: PASS, every frame done, step times and
    samples recorded; no device memory to sample there."""
    video = tmp_path / "in.mp4"
    _clip(video, 40, 12, rolling=False)
    out = tmp_path / "SOAK_device_smoke.json"
    p = _run_soak(["--device_only", "200", "--video", str(video),
                   "--out", str(out), "--depth_stride", "2",
                   "--batch_size", "4", "--input_size", "56",
                   "--compute_dtype", "float32"], tmp_path)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    assert "device soak PASS" in p.stdout
    art = json.loads(out.read_text())
    assert art["mode"] == "device_only"
    assert art["frames"] >= 200
    assert art["step_ms_per_frame"]["p50"] > 0
    assert art["samples"], "no endurance samples recorded"
    assert soak.memory_flat([1000.0, 1060.0])
    assert not soak.memory_flat([1000.0, 1070.0])
    assert soak.memory_flat([4000.0, 4190.0]) and soak.memory_flat([])


def test_soak_gen_writes_the_frames_asked_for(tmp_path):
    """soak_gen at 64 x 96: the frame count and size asked for, the blocks
    moving over the rolling gradient."""
    from vr_video_generator_tpu_torch.video.reader import (VideoReader,
                                                           probe_video)

    path = str(tmp_path / "gen.mp4")
    assert soak_gen.main([path, "12", "64x96"]) == 0
    _, n, w, h = probe_video(path)
    assert (n, w, h) == (12, 96, 64)
    reader = VideoReader(path, 0, backend="cv2")
    try:
        frames = np.stack(list(reader.frames(0, 12)))
    finally:
        reader.close()
    assert frames.shape == (12, 64, 96, 3)
    assert np.abs(frames[0].astype(int) - frames[5]).mean() > 1


@pytest.mark.parametrize("call", ["perf_compare", "host_io_bench",
                                  "soak_device_only", "parity_report"])
def test_tools_refuse_a_missing_card(call, tmp_path):
    """Each tool takes the card unless --device cpu is given; without one
    it raises before measuring anything on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present; the refusal is for machines "
                    "without one")
    video = tmp_path / "in.mp4"
    _clip(video, 8, 13, rolling=False)
    runs = {
        "perf_compare": lambda: perf_compare.main([]),
        "host_io_bench": lambda: host_io_bench.report(h=8, w=8, n_frames=1,
                                                      reps=1),
        "soak_device_only": lambda: soak.main(
            ["--device_only", "8", "--video", str(video), "--out",
             str(tmp_path / "s.json"), "--input_size", "56"]),
        "parity_report": lambda: parity_report.main(
            ["--video", str(video), "--frames", "2", "--input_size", "56"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        runs[call]()
