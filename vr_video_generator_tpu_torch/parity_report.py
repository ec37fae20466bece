"""End-to-end parity report: the port's SBS output against the reference
algorithm, frame by frame, under a per-pixel gate.

The counterpart of scripts/parity_report.py, with its flags (``--device
cpu|cuda`` in place of ``cpu|tpu``), its gate and its per-frame lines.

Our side: ``SbsPipeline.step`` over the first ``--frames`` frames of
``--video`` as one batch, on the card (``--device``) at
``--compute_dtype``. Reference side, a frame at a time: the port's own model
on the CPU at f32 with the same weights, in its plain path (``infer_depth``:
preprocess, forward, bicubic upsample, times the scaler), then the numpy
oracle of the reference's stereo synthesis, ``tests/oracle/warp_oracle.py``
``OracleSbs``, which is independent of both packages and keeps the temporal
state across frames as the pipeline does across a batch. That depth stands
in for upstream's ``infer_image``, which needs the upstream checkout; the
repository's CPU tests hold this plain path against the JAX package.

Gate: a frame passes when the fraction of pixels that deviate by more than
``--gate`` (in [0, 1]) is at most ``--frac_budget`` and its mean deviation
is at most ``--gate``. A mean gate alone could hide a localized warp fault;
a max gate means nothing here, since a 1-ulp depth difference at a plane's
boundary may shift single pixels by a whole plane offset. The exit code is
0 only when every frame passes.

``--encoder_path`` loads the same ``.pth`` or checkpoint directory
(``models/checkpoint.py``) on both sides; without it both sides run seeded
random weights. ``--spread_depth`` recentres and amplifies the final 1x1
head conv so that random weights give depth over ~[0, 9.5] (a deep random
encoder averages the input away and gives a near-flat map, which makes the
warp a single plane and the comparison vacuous); both sides share the
changed weights. The first frame's maximum lands at 9.5, midway between
two integers: the plane tables start from ceil(max depth), so a maximum
put on an integer (the JAX script's 9.0) lets a last-ulp difference
between the two sides' depths move every plane of that frame, and the
offset range's EWMA carries that into the next frames. ``--depth_scaler``
overrides the scaler on both sides.

Usage:
    python3 -m vr_video_generator_tpu_torch.parity_report --video in.mp4
        [--frames 8] [--encoder vits --encoder_path ckpt.pth]
        [--input_size 518] [--device cpu|cuda]
        [--compute_dtype float32|bfloat16] [--spread_depth]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FINAL_CONV = "depth_head.scratch.output_conv2.2"
# --spread_depth's target for the probe frame's maximum depth: midway
# between two integers, away from the jump of ceil(max depth).
SPREAD_MAX = 9.5
SEED = 0


def frame_stats(ours: np.ndarray, ref: np.ndarray,
                gate: float) -> Tuple[float, float, float]:
    """(mean, max, fraction over ``gate``) of |ours - ref| / 255."""
    diff = np.abs(ours.astype(np.float64) - ref.astype(np.float64)) / 255.0
    return float(diff.mean()), float(diff.max()), float((diff > gate).mean())


def gate_passes(stats, gate: float, frac_budget: float) -> bool:
    """The per-pixel gate over every frame's (mean, max, fraction)."""
    return all(frac <= frac_budget and mean <= gate
               for mean, _, frac in stats)


def report_lines(stats, gate: float, frac_budget: float) -> List[str]:
    """The per-frame lines and the RESULT line of the JAX script."""
    lines = [f"frame {i}: mean={mean:.5f} max={mx:.3f} "
             f"frac_over_gate={frac:.6f}"
             for i, (mean, mx, frac) in enumerate(stats)]
    worst_mean = max((s[0] for s in stats), default=0.0)
    worst_max = max((s[1] for s in stats), default=0.0)
    worst_frac = max((s[2] for s in stats), default=0.0)
    verdict = "PASS" if gate_passes(stats, gate, frac_budget) else "FAIL"
    lines.append(f"RESULT: worst frac(|diff|>{gate}) = {worst_frac:.6f} "
                 f"(budget {frac_budget}), worst mean = {worst_mean:.5f}, "
                 f"worst max = {worst_max:.3f} -> {verdict}")
    return lines


def spread_depth(state_dict: dict, ref_model, probe: np.ndarray,
                 input_size: int, scaler: float) -> dict:
    """``state_dict`` with the final head conv recentred and amplified so
    that the scaled depth of ``probe`` spans ~[0, SPREAD_MAX]: weight x g,
    bias -> (bias - median) x g, g = SPREAD_MAX / (scaler (max - median))
    of its raw depth."""
    from vr_video_generator_tpu_torch.models.depth_anything_v2 import \
        infer_depth

    with torch.inference_mode():
        raw = infer_depth(ref_model, torch.from_numpy(probe[None]),
                          input_size=input_size)[0].double().numpy() / scaler
    med, mx = float(np.median(raw)), float(raw.max())
    g = SPREAD_MAX / max(scaler * (mx - med), 1e-12)
    sd = dict(state_dict)
    sd[f"{FINAL_CONV}.weight"] = state_dict[f"{FINAL_CONV}.weight"] * g
    sd[f"{FINAL_CONV}.bias"] = (state_dict[f"{FINAL_CONV}.bias"] - med) * g
    print(f"spread_depth: median={med:.6g} max={mx:.6g} gain={g:.4g}",
          flush=True)
    return sd


def run(args) -> Tuple[List[Tuple[float, float, float]], List[str]]:
    """(each frame's (mean, max, fraction over the gate), the lines)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tests.oracle.warp_oracle import OracleSbs
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.models.depth_anything_v2 import \
        infer_depth
    from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                             load_model)
    from vr_video_generator_tpu_torch.pipeline import (SbsPipeline,
                                                       resolve_device)
    from vr_video_generator_tpu_torch.utils.config import DEPTH_SCALERS
    from vr_video_generator_tpu_torch.video.reader import VideoReader

    device = resolve_device(args.device)
    scaler = (args.depth_scaler if args.depth_scaler is not None
              else DEPTH_SCALERS[args.encoder])
    run_cfg = RunConfig(encoder=args.encoder, input_size=args.input_size,
                        compute_dtype=args.compute_dtype,
                        depth_scaler=scaler)
    cfg = run_cfg.model()
    real = bool(args.encoder_path and os.path.exists(args.encoder_path))
    if real:
        weights = f"real:{os.path.basename(args.encoder_path)}"
    else:
        print("note: no checkpoint given — using seeded random weights")
        weights = "seeded-random"
    ref_model = load_model(args.encoder, args.encoder_path if real else None,
                           dtype=torch.float32, device="cpu",
                           allow_random=not real, seed=SEED, cfg=cfg)

    reader = VideoReader(args.video)
    try:
        frames = np.stack(list(reader.frames(0, args.frames)))
    finally:
        reader.close()
    h, w = frames.shape[1:3]

    if args.spread_depth:
        sd = spread_depth(ref_model.state_dict(), ref_model, frames[0],
                          args.input_size, scaler)
        ref_model = build_model(cfg, sd, torch.float32, "cpu")
    else:
        sd = ref_model.state_dict()

    run_cfg = dataclasses.replace(run_cfg, batch_size=len(frames))
    dtype = (torch.float32 if args.compute_dtype == "float32"
             else torch.bfloat16)
    pipe = SbsPipeline(build_model(cfg, sd, dtype, device,
                                   tail=run_cfg.tail), h, w, run_cfg=run_cfg)
    sbs, _ = pipe.step(frames, pipe.initial_state())
    ours = sbs.cpu().numpy()
    print(f"ours: device={device} dtype={args.compute_dtype} "
          f"weights={weights} encoder={args.encoder} {w}x{h} "
          f"input_size={args.input_size}", flush=True)

    oracle = OracleSbs()
    stats = []
    for i, frame in enumerate(frames):
        with torch.inference_mode():
            depth = infer_depth(ref_model, torch.from_numpy(frame[None]),
                                input_size=args.input_size)[0].numpy()
        stats.append(frame_stats(ours[i], oracle.process(frame, depth),
                                 args.gate))
    lines = report_lines(stats, args.gate, args.frac_budget)
    for line in lines:
        print(line, flush=True)
    return stats, lines


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--video", required=True)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--encoder", default="vits")
    ap.add_argument("--encoder_path", default=None)
    ap.add_argument("--input_size", type=int, default=518)
    ap.add_argument("--gate", type=float, default=1e-2,
                    help="per-pixel abs-diff tolerance in [0,1]")
    ap.add_argument("--frac_budget", type=float, default=1e-3,
                    help="max fraction of pixels allowed over --gate")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                    help="where OUR pipeline runs (the reference side runs "
                         "on the CPU at f32)")
    ap.add_argument("--compute_dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--depth_scaler", type=float, default=None,
                    help="override the encoder's depth rescale constant on "
                         "BOTH sides")
    ap.add_argument("--spread_depth", action="store_true",
                    help="recentre and amplify the final head conv so that "
                         "random weights give depth over ~[0, 9.5]; both "
                         "sides share the changed weights")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    stats, _ = run(args)
    return 0 if gate_passes(stats, args.gate, args.frac_budget) else 1


if __name__ == "__main__":
    sys.exit(main())
