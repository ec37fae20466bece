"""The port's headline benchmark: SBS conversion throughput on one GPU.

Run from the root of a checkout:

    python3 -m vr_video_generator_tpu_torch.bench [--config N]
        [--chunk_batches K] [--depth_stride S] [--device cuda|cpu]

The counterpart of the root ``bench.py``, at its configurations (``CONFIGS``,
a copy of its table): the encoder, geometry, batch and offset step of
config N (default 2: vits, 1080p, batch 8), bf16, ``--input_size`` 518,
numpy-seeded random weights with the depth scaler calibrated on the first
batch (``stage_bench.calibrate_random_scaler``), and the CLI's defaults
otherwise (``--mlp_fused auto --tail auto``, u8 output, PyTorch's own
numeric settings). ``--depth_stride S`` runs the depth net on every S-th
frame (as the root bench's flag; the metric gets ``_stride<S>``); a config
whose batch S does not divide is skipped with a message. ``--device cpu``
shrinks to the root bench's smoke geometry (vits, 270 x 480, input 126,
batch max(2, S), f32) and its two steps a chain. It measures two rates:

* device-resident frames/s: ``--steps`` chained steps on one batch already
  on the device, its SBS and state feeding a device checksum that the next
  step's frames depend on (``utils.benchlib.device_time``), CUDA events,
  best of ``--reps``; with ``--chunk_batches K`` > 1 the steps go K at a
  time through ``SbsPipeline.step_many`` (one CUDA graph replay on the
  card), otherwise through ``step``;
* host-inclusive frames/s: ``process_segment`` over ``--segment_batches``
  batches of in-memory frames at the same ``chunk_batches``
  (``stage_bench.run_segment``: decode thread, pinned upload, dispatch,
  readback, the writer's hand-off, no encode), best of ``--reps``, after a
  warm-up run that builds the kernels and captures the graphs.

It prints one JSON line: ``{"metric": "torch_sbs_fps_<h>p_<encoder>",
"value": <device-resident>, "unit": "frames/s", "vs_baseline": <value /
12>, "host_fps": <host-inclusive>, "chunk_batches": K, "card": "<name,
power limit>"}`` and the runs behind both rates; ``card`` is nvidia-smi's
line on the card and null with ``--device cpu``. The baseline is the
reference's ~12 frames/s at 1080p (the root bench's ``BASELINE_FPS``).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

# (encoder, height, width, batch, offset_step_size) per config: the root
# bench.py's table.
CONFIGS = {
    1: ("vits", 480, 854, 8, 2),
    2: ("vits", 1080, 1920, 8, 1),
    3: ("vitb", 1080, 1920, 8, 1),
    4: ("vitl", 1440, 2560, 4, 1),
    5: ("vitl", 2160, 3840, 4, 1),
}
BASELINE_FPS = 12.0
SEED = 0


class Chain:
    """One link of the device-resident chain: a step (k = 1) or a
    ``step_many`` of k batches, carrying the state from call to call."""

    def __init__(self, pipe, k: int):
        self.pipe, self.k = pipe, k
        self.state = pipe.initial_state()

    def __call__(self, frames: torch.Tensor):
        if self.k == 1:
            sbs, self.state = self.pipe.step(frames, self.state)
        else:
            sbs, self.state = self.pipe.step_many(frames, self.state)
        return sbs, self.state


def run_config(config: int, chunk_batches: int = 1, device: str = "cuda",
               steps: int = 0, reps: int = 6, segment_batches: int = 12,
               depth_stride: int = 1) -> dict:
    """The JSON line of one configuration; ``steps`` 0 is 8 on the card
    and 2 on the CPU, rounded up to whole chunks."""
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline
    from vr_video_generator_tpu_torch.stage_bench import (
        calibrate_random_scaler, card_line, run_segment)
    from vr_video_generator_tpu_torch.utils.benchlib import device_time

    on_card = torch.device(device).type == "cuda"
    encoder, h, w, b, step = CONFIGS[config]
    if not on_card:
        encoder, h, w, b = "vits", 270, 480, max(2, depth_stride)
    cfg = RunConfig(encoder=encoder, batch_size=b, offset_step_size=step,
                    input_size=518 if on_card else 126,
                    compute_dtype="bfloat16" if on_card else "float32",
                    chunk_batches=chunk_batches, depth_stride=depth_stride)
    pipe = SbsPipeline.create(cfg, h, w, allow_random=True, device=device,
                              seed=SEED)
    frames = np.random.default_rng(SEED).integers(
        0, 256, (segment_batches * b, h, w, 3), dtype=np.uint8)
    calibrate_random_scaler(pipe, frames[:b])

    k = chunk_batches
    calls = -(-(steps or (8 if on_card else 2)) // k)
    batch = pipe.frames_to_device(frames[:b])
    chain_in = batch if k == 1 else torch.stack([batch] * k)
    per_call, _ = device_time(Chain(pipe, k), chain_in, k=calls, reps=reps)
    fps = k * b / per_call

    run_segment(pipe, frames)  # warm-up: kernels built, graphs captured
    host = [len(frames) / run_segment(pipe, frames)[0] for _ in range(reps)]
    tag = f"_stride{depth_stride}" if depth_stride > 1 else ""
    return {"metric": f"torch_sbs_fps_{h}p_{encoder}{tag}", "value": fps,
            "unit": "frames/s", "vs_baseline": fps / BASELINE_FPS,
            "host_fps": max(host), "chunk_batches": k,
            "depth_stride": depth_stride,
            "card": card_line() if on_card else None,
            "config": config, "device": str(pipe.device),
            "steps": calls * k, "reps": reps,
            "device_resident_s_per_frame": per_call / (k * b),
            "host_frames": len(frames), "host_fps_runs": host}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", type=int, default=2, choices=sorted(CONFIGS))
    ap.add_argument("--chunk_batches", type=int, default=1,
                    help="steps a step_many call takes (1: step)")
    ap.add_argument("--depth_stride", type=int, default=1,
                    help="run the depth net on every S-th frame (1: every "
                         "frame)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu runs the root bench's smoke geometry")
    ap.add_argument("--steps", type=int, default=0,
                    help="chained steps a timed chain (0: 8 on the card, "
                         "2 on the CPU)")
    ap.add_argument("--reps", type=int, default=6,
                    help="timed repeats of each rate; the best is reported")
    ap.add_argument("--segment_batches", type=int, default=12,
                    help="batches of frames the host-inclusive run takes")
    opts = ap.parse_args(argv)
    if opts.chunk_batches < 1:
        ap.error("--chunk_batches must be >= 1")
    if opts.depth_stride < 1:
        ap.error("--depth_stride must be >= 1")
    batch = CONFIGS[opts.config][3]
    if opts.device == "cuda" and batch % opts.depth_stride:
        print(f"config {opts.config}: skipped: depth_stride "
              f"{opts.depth_stride} does not divide its batch {batch}",
              file=sys.stderr)
        return 0
    line = run_config(opts.config, opts.chunk_batches, opts.device,
                      opts.steps, opts.reps, opts.segment_batches,
                      opts.depth_stride)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
