"""Depth-stride fidelity study: what ``--depth_stride`` costs on motion.

The port's counterpart of ``scripts/stride_study.py``. Run from the root of
a checkout:

    python3 -m vr_video_generator_tpu_torch.stride_study [--device cuda|cpu]
        [--frames N]

The stride runs the depth net on every s-th frame and lerps raw depth in
between. Against the stride-1 run as ground truth, for strides 2, 4 and 8
at two pan speeds (slow: 1/98 of the width a frame, fast: 6/98, as the
script's 1 and 6 px at its 98 px), it reports:

* the RAW DEPTH error of the lerped maps (RMS, 99th percentile and max of
  |error|, each in % of the ground-truth depth range): the lerp of the
  stride-1 depth's anchors (frames s-1, 2s-1, ...; the cold start holds
  anchor 0) against that depth;
* the SBS divergence of the whole pipeline at stride s against stride 1:
  the share of pixels that differ after the first stride group (steady
  state), the mean |difference| of the u8 values that differ, and the
  share in the first group (a cold start holds anchor 0 there).

Three arms, as in the script: ``random`` (seeded random weights), ``spread``
(the same weights with the head's last 1x1 conv rescaled so depth spans
~[0, 9] with real plane structure) and ``coherent`` (synthetic smooth depth,
a floor gradient and a blob riding the foreground square, straight into the
warp: no depth net). ``--device cpu`` runs the script's tiny model at its
56 x 98 geometry with its 10x offsets (at 56 rows the default offsets put
the whole depth range in ~1.4 px of shift); ``--device cuda`` runs vits at
1080p, bf16, ``--input_size`` 518, batch 8, the CLI's default offsets, with
the depth scaler of the random arm calibrated to peak at 12
(``stage_bench.calibrate_random_scaler``). The last line is one JSON object
with every number and, on the card, nvidia-smi's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List

import numpy as np
import torch

STRIDES = (2, 4, 8)
BATCH = 8
SEED = 0


def make_scene(n: int, h: int, w: int, speed: int) -> np.ndarray:
    """A mid-contrast texture panning ``speed`` px a frame and a bright
    square (about a fifth of the height) moving diagonally at twice that."""
    rng = np.random.default_rng(7)
    tex = (rng.integers(0, 255, (h, 2 * w, 3), dtype=np.uint8) // 2 + 64
           ).astype(np.uint8)
    side = max(2, round(12 * h / 56))
    frames = np.empty((n, h, w, 3), np.uint8)
    for t in range(n):
        off = (t * speed) % w
        frames[t] = tex[:, off:off + w]
        y = (5 + 2 * speed * t) % (h - side)
        x = (9 + 2 * speed * t) % (w - side)
        frames[t, y:y + side, x:x + side] = (250, 240, 80)
    return frames


def make_depth(n: int, h: int, w: int, speed: int) -> np.ndarray:
    """Temporally coherent depth matched to make_scene's motion: a floor
    gradient over [1, 3] and a depth-9 gaussian blob on the square."""
    side = max(2, round(12 * h / 56))
    sigma = 7.0 * h / 56
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 1.0 + 2.0 * yy / h
    depth = np.empty((n, h, w), np.float32)
    for t in range(n):
        cy = (5 + 2 * speed * t) % (h - side) + side / 2
        cx = (9 + 2 * speed * t) % (w - side) + side / 2
        blob = 8.0 * np.exp(-(((yy - cy) / sigma) ** 2
                              + ((xx - cx) / sigma) ** 2))
        depth[t] = base + blob
    return depth


def interp_depth(depth: np.ndarray, stride: int) -> np.ndarray:
    """ops/temporal.stride_interpolate over a whole cold sequence, on the
    host."""
    anchors = depth[stride - 1::stride]
    prev = np.concatenate([anchors[:1], anchors[:-1]])
    wgt = (np.arange(1, stride + 1, dtype=np.float32)
           / stride)[None, :, None, None]
    out = prev[:, None] * (1 - wgt) + anchors[:, None] * wgt
    return out.reshape(depth.shape)


def run(pipe, frames: np.ndarray) -> np.ndarray:
    out, state = [], pipe.initial_state()
    for i in range(0, len(frames), BATCH):
        sbs, state = pipe.step(frames[i:i + BATCH], state)
        out.append(sbs.cpu().numpy())
    return np.concatenate(out)


def depth_stats(approx: np.ndarray, true: np.ndarray, stride: int) -> Dict:
    span = float(true.max() - true.min()) or 1.0
    err = np.abs(approx - true)[stride:]  # steady state
    return dict(depth_rms_pct=float(np.sqrt((err ** 2).mean())) / span * 100,
                depth_p99_pct=float(np.percentile(err, 99)) / span * 100,
                depth_max_pct=float(err.max()) / span * 100)


def sbs_stats(sbs: np.ndarray, ref: np.ndarray, stride: int) -> Dict:
    diff = sbs.astype(np.int16) - ref.astype(np.int16)
    differs = np.abs(diff).max(axis=-1) > 0
    body = diff[stride:]
    return dict(sbs_diff_px_pct=float(differs[stride:].mean()) * 100,
                sbs_mean_abs_u8=(float(np.abs(body[body != 0]).mean())
                                 if (body != 0).any() else 0.0),
                sbs_cold_px_pct=float(differs[:stride].mean()) * 100)


def spread_state_dict(sd: Dict, raw: np.ndarray, target_span: float = 9.0
                      ) -> Dict:
    """The head's last 1x1 conv rescaled so that, at depth scaler 1, the
    depth of a probe frame (``raw``: its depth before the scaler) spans
    about [0, target_span] from its median up, the ReLU clamping what lies
    below (the script's ``spread_params``)."""
    key = "depth_head.scratch.output_conv2.2"
    med, mx = float(np.median(raw)), float(raw.max())
    g = target_span / max(mx - med, 1e-12)
    out = dict(sd)
    out[f"{key}.weight"] = (sd[f"{key}.weight"] * g).astype(np.float32)
    out[f"{key}.bias"] = ((sd[f"{key}.bias"] - med) * g).astype(np.float32)
    return out


def study(device: str, n_frames: int) -> Dict:
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                             random_state_dict)
    from vr_video_generator_tpu_torch.ops.warp import WarpSpec
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline
    from vr_video_generator_tpu_torch.stage_bench import calibrate_random_scaler
    from vr_video_generator_tpu_torch.utils.config import (ModelConfig,
                                                           StereoConfig)

    on_card = torch.device(device).type == "cuda"
    if on_card:
        h, w = 1080, 1920
        cfg = RunConfig(encoder="vits", batch_size=BATCH, input_size=518,
                        compute_dtype="bfloat16")
        model_cfg = cfg.model()
        dtype = torch.bfloat16
    else:
        h, w = 56, 98
        cfg = RunConfig(batch_size=BATCH, input_size=56,
                        compute_dtype="float32", offset_fg=0.25,
                        offset_bg=-0.1)
        model_cfg = ModelConfig(encoder="vits", embed_dim=32, depth=4,
                                num_heads=2, mlp_ratio=4.0, features=16,
                                out_channels=(8, 16, 32, 32),
                                intermediate_layers=(0, 1, 2, 3),
                                depth_scaler=1.618)
        dtype = torch.float32
    sd = random_state_dict(model_cfg, SEED)
    speeds = {"slow": max(1, round(w / 98)), "fast": max(6, round(6 * w / 98))}
    scenes = {name: make_scene(n_frames, h, w, v) for name, v in speeds.items()}

    def pipeline(state_dict, scaler, stride):
        model = build_model(model_cfg, state_dict, dtype, device,
                            tail=cfg.tail)
        model.cfg = dataclasses.replace(model.cfg, depth_scaler=scaler)
        return SbsPipeline(model, h, w, run_cfg=dataclasses.replace(
            cfg, depth_stride=stride))

    probe = pipeline(sd, model_cfg.depth_scaler, 1)
    scaler = (calibrate_random_scaler(probe, scenes["slow"][:BATCH])
              if on_card else model_cfg.depth_scaler)
    raw = probe.depth_only(scenes["slow"][:1]).float().cpu().numpy() \
        / probe.model.cfg.depth_scaler
    del probe
    arms = {"random": (sd, scaler), "spread": (spread_state_dict(sd, raw),
                                               1.0)}
    rows: List[Dict] = []
    for arm, (state_dict, arm_scaler) in arms.items():
        pipes = {s: pipeline(state_dict, arm_scaler, s)
                 for s in (1,) + STRIDES}
        for scene, frames in scenes.items():
            ref = run(pipes[1], frames)
            true = np.concatenate([
                pipes[1].depth_only(frames[i:i + BATCH]).float().cpu().numpy()
                for i in range(0, n_frames, BATCH)])
            for s in STRIDES:
                rows.append(dict(arm=arm, scene=scene, stride=s,
                                 **depth_stats(interp_depth(true, s), true, s),
                                 **sbs_stats(run(pipes[s], frames), ref, s)))
        del pipes

    spec = WarpSpec.create(h, w, StereoConfig(offset_fg=cfg.offset_fg,
                                              offset_bg=cfg.offset_bg),
                           impl=cfg.warp_impl, device=device)

    def warp(frames, depth):
        d = torch.from_numpy(depth).to(device)
        ls = torch.ceil(d.flatten(1).amax(dim=1))
        ranges = torch.stack([spec.cfg.offset_bg * h * ls / 14.0,
                              spec.cfg.offset_fg * h * ls / 14.0], dim=1)
        with torch.inference_mode():
            return spec.warp_batch(torch.from_numpy(frames).to(device), d,
                                   ranges).cpu().numpy()

    for scene, v in speeds.items():
        true = make_depth(n_frames, h, w, v)
        ref = warp(scenes[scene], true)
        for s in STRIDES:
            approx = interp_depth(true, s)
            rows.append(dict(arm="coherent", scene=scene, stride=s,
                             **depth_stats(approx, true, s),
                             **sbs_stats(warp(scenes[scene], approx), ref, s)))
    return dict(device=device, geometry=[h, w], frames=n_frames,
                batch=BATCH, speeds_px=speeds, depth_scaler=scaler,
                offsets=[cfg.offset_fg, cfg.offset_bg], rows=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--frames", type=int, default=32,
                    help="rounded up to a multiple of 8, at least 16 (the "
                         "batch and the stride-8 arm need whole groups, and "
                         "its steady state starts at frame 8)")
    opts = ap.parse_args(argv)
    n = max(16, -(-opts.frames // 8) * 8)
    card = None
    if opts.device == "cuda":
        from vr_video_generator_tpu_torch.pipeline import resolve_device
        from vr_video_generator_tpu_torch.stage_bench import card_line

        resolve_device("cuda")
        card = card_line()
        print(card, flush=True)
    result = study(opts.device, n)
    print(f"{n} frames {result['geometry'][1]}x{result['geometry'][0]} on "
          f"{opts.device}; depth errors in % of the true depth range, "
          f"steady state (after the first group)")
    print(f"{'arm':>8} {'scene':>5} {'stride':>6} {'RMS%':>7} {'p99%':>7} "
          f"{'max%':>7} {'SBS px%':>8} {'mean|d|':>8} {'cold px%':>8}")
    for r in result["rows"]:
        print(f"{r['arm']:>8} {r['scene']:>5} {r['stride']:>6} "
              f"{r['depth_rms_pct']:>7.2f} {r['depth_p99_pct']:>7.2f} "
              f"{r['depth_max_pct']:>7.2f} {r['sbs_diff_px_pct']:>8.2f} "
              f"{r['sbs_mean_abs_u8']:>8.2f} {r['sbs_cold_px_pct']:>8.2f}")
    print(json.dumps(dict(result, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
