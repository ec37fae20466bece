"""Real-checkpoint validation runbook: the one command between "the
Depth-Anything-V2 weights arrive" and "the port is proven on them".

The port's counterpart of scripts/real_weights_runbook.py, with its flags
(``--device cpu|cuda``, default ``cuda``, in place of ``cpu|tpu``), its
configs, its scaler calibration and its artifact:

    python3 -m vr_video_generator_tpu_torch.real_weights_runbook \\
        --checkpoints_dir ./checkpoints [--device cuda|cpu] [--frames 4] \\
        [--configs 1,2,3,4,5] [--out REAL_WEIGHTS_REPORT.json]

For each config whose encoder checkpoint exists
(``depth_anything_v2_{vits,vitb,vitl,vitg}.pth``) it:

  1. loads the ``.pth`` with ``models.factory.load_model``;
  2. holds the depth of ``--device`` at f32 (on the card the f32 kernel
     path) against the port's plain path on the CPU at f32, both through
     ``models.depth_anything_v2.infer_depth``, frame by frame relative to
     the reference's range (mean < 1e-3, max < 5e-2). That CPU path stands
     in for upstream's ``infer_image``, which needs the upstream checkout;
     the repository's CPU tests hold it against the JAX package;
  3. checks the raw (pre-scaler) depth maximum against the reference's
     documented per-encoder bands (reference PredictAndGenerate.py:27-34)
     and the scaled maximum against ``StereoConfig.limit_step_cap``; an
     off-family checkpoint (vitg, which has no band, or one outside its
     band or over the cap with the shipped scaler) gets a scaler
     CALIBRATED to the family's ~[0, 14] range (:func:`calibrate_scaler`),
     reported in the artifact and usable in production via
     ``--depth_scaler``;
  4. runs ``python3 -m vr_video_generator_tpu_torch.parity_report`` (the
     SBS per-pixel gate) at the config's geometry on ``--device`` at
     ``--compute_dtype``, with the calibrated scaler on both sides;

and writes one PASS/FAIL row per config to the JSON artifact. The exit code
is 0 only when every config that has a checkpoint passes and one does.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import List, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (encoder, height, width, offset_step_size) — BASELINE.json configs 1-5,
# plus 6 = vitg at 1080p (no BASELINE row: no official DA-V2 vitg checkpoint
# exists; the row makes the runbook the one command for that day too).
CONFIGS = {
    1: ("vits", 480, 854, 2),
    2: ("vits", 1080, 1920, 1),
    3: ("vitb", 1080, 1920, 1),
    4: ("vitl", 1440, 2560, 1),
    5: ("vitl", 2160, 3840, 1),
    6: ("vitg", 1080, 1920, 1),
}
# Pre-scaler depth.max() ranges the reference's scalers were calibrated on
# (reference PredictAndGenerate.py:27-34). Wide margins: scene-dependent.
# None = no reference calibration exists (vitg): ALWAYS derive the scaler.
EXPECTED_RAW_MAX = {"vits": (4.0, 14.0), "vitb": (8.0, 28.0),
                    "vitl": (250.0, 900.0), "vitg": None}

# Scaled-depth target the reference family lands on: vits 8-9 x 1.618 ~ 14.6,
# vitb 16-18 x 0.8 ~ 14.4, vitl 550-600 x 0.0208 ~ 12.5 (all pre /14
# normalisation, reference PredictAndGenerate.py:27-34,102-104). 13.5 sits
# inside that family band, under StereoConfig.limit_step_cap (24), and
# midway between two integers: the parity step's reference frame peaks at
# the target, and the plane tables start from ceil(max depth) of the
# temporally blended depth, so a target on an integer (the JAX script's
# 13.0) lets a last-ulp difference between the two sides move every plane
# of that frame (and, through the offset range's EWMA, of the next ones).
CAL_TARGET_MAX = 13.5


def calibrate_scaler(raw_depth_max: float,
                     target_max: float = CAL_TARGET_MAX) -> float:
    """Scaler that lands a checkpoint's raw depth range on the reference
    family's ~[0, 14] scaled range. Used for vitg (the reference defines no
    scaler — no official checkpoint exists) and for any off-family
    checkpoint whose raw range misses the documented band."""
    return target_max / max(float(raw_depth_max), 1e-12)


def scaler_decision(encoder: str, raw_max: float, shipped: float,
                    cap: float) -> dict:
    """Whether to calibrate, and the scaler used: calibrate when the shipped
    scaler was never validated for this family (vitg), when the raw range
    misses the documented band, or when the shipped scaler would exceed the
    step cap (an off-family fine-tune); the calibrated scaler is
    ``calibrate_scaler(raw_max)``, against the reference's ~[0, 14]."""
    family = EXPECTED_RAW_MAX[encoder]
    raw_range_ok = family is not None and family[0] <= raw_max <= family[1]
    calibrated = (not raw_range_ok) or (raw_max * shipped > cap)
    scaler_used = calibrate_scaler(raw_max) if calibrated else shipped
    scaled_max = raw_max * scaler_used
    return {"calibrated": calibrated, "scaler_used": scaler_used,
            "scaled_depth_max": scaled_max, "raw_range_ok": raw_range_ok,
            "under_step_cap": scaled_max <= cap}


def synth_clip(path: str, h: int, w: int, n: int = 8, seed: int = 7) -> None:
    import cv2

    rng = np.random.default_rng(seed)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    base = rng.random((h // 16 + 1, w // 16 + 1, 3))
    for i in range(n):
        small = np.roll(base, i * 2, axis=1)
        frame = cv2.resize((small * 255).astype(np.uint8), (w, h),
                           interpolation=cv2.INTER_CUBIC)
        vw.write(frame)
    vw.release()


def depth_golden(encoder: str, ckpt: str, video: str, frames: int,
                 input_size: int, device: str = "cuda") -> dict:
    """The depth of ``device`` at f32 against the plain CPU f32 path on the
    same checkpoint, the raw range check and the scaler decision."""
    import torch

    from vr_video_generator_tpu_torch.models.depth_anything_v2 import \
        infer_depth
    from vr_video_generator_tpu_torch.models.factory import load_model
    from vr_video_generator_tpu_torch.pipeline import resolve_device
    from vr_video_generator_tpu_torch.utils.config import (DEPTH_SCALERS,
                                                           StereoConfig)
    from vr_video_generator_tpu_torch.video.reader import VideoReader

    dev = resolve_device(device)
    with VideoReader(video) as reader:
        fr = np.stack([f for _, f in zip(range(frames),
                                         reader.frames(0, frames))])
    shipped = DEPTH_SCALERS[encoder]
    ref_model = load_model(encoder, ckpt, dtype=torch.float32, device="cpu")
    model = load_model(encoder, ckpt, dtype=torch.float32, device=dev)
    # infer_depth multiplies by the model's scaler (the shipped one): both
    # sides are divided by it, so the comparison and the range check are on
    # the raw depth, as the JAX script's upstream side is.
    with torch.inference_mode():
        ours = infer_depth(model, torch.from_numpy(fr).to(dev),
                           input_size=input_size).cpu().numpy() / shipped
    del model
    worst_mean = worst_max = 0.0
    raw_maxes = []
    for i, f in enumerate(fr):
        with torch.inference_mode():
            ref = infer_depth(ref_model, torch.from_numpy(f[None]),
                              input_size=input_size)[0].numpy() / shipped
        raw_maxes.append(float(ref.max()))
        scale = max(float(np.abs(ref).max()), 1e-6)
        d = np.abs(ours[i] - ref) / scale
        worst_mean = max(worst_mean, float(d.mean()))
        worst_max = max(worst_max, float(d.max()))

    raw_max = max(raw_maxes)
    return {"depth_rel_mean": worst_mean, "depth_rel_max": worst_max,
            "raw_depth_max": raw_max, "shipped_scaler": shipped,
            **scaler_decision(encoder, raw_max, shipped,
                              StereoConfig().limit_step_cap),
            "depth_ok": worst_mean < 1e-3 and worst_max < 5e-2}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoints_dir", default="./checkpoints")
    ap.add_argument("--video", default="",
                    help="use this clip for every config instead of "
                         "synthesizing per-geometry clips")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--input_size", type=int, default=518)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    ap.add_argument("--compute_dtype", default=None,
                    choices=[None, "float32", "bfloat16"],
                    help="of the parity step; default: bfloat16 on cuda, "
                         "float32 on cpu (the golden depth is always f32)")
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--out", default="REAL_WEIGHTS_REPORT.json")
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "real_weights_runbook"))
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from vr_video_generator_tpu_torch.pipeline import resolve_device

    resolve_device(args.device)  # no card for --device cuda: raise, no CPU
    dtype = args.compute_dtype or (
        "bfloat16" if args.device == "cuda" else "float32")

    os.makedirs(args.workdir, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH", "")) if p)
    rows = []
    golden_cache = {}
    for c in [int(x) for x in args.configs.split(",") if x]:
        encoder, h, w, _ = CONFIGS[c]
        ckpt = os.path.join(args.checkpoints_dir,
                            f"depth_anything_v2_{encoder}.pth")
        row = {"config": c, "encoder": encoder, "geometry": f"{w}x{h}",
               "checkpoint": ckpt}
        if not os.path.exists(ckpt):
            row["status"] = "SKIP (checkpoint missing)"
            rows.append(row)
            print(json.dumps(row), flush=True)
            continue

        video = args.video or os.path.join(args.workdir, f"clip_{h}p.mp4")
        if not args.video and not os.path.exists(video):
            synth_clip(video, h, w)

        # Key by (encoder, clip): configs sharing an encoder run different
        # geometry clips, and the depth-range/step-cap gate must be judged
        # on the clip this row's parity run actually saw.
        if (encoder, video) not in golden_cache:
            golden_cache[encoder, video] = depth_golden(
                encoder, ckpt, video, args.frames, args.input_size,
                args.device)
        golden = row["golden_depth"] = golden_cache[encoder, video]

        cmd = [sys.executable, "-m",
               "vr_video_generator_tpu_torch.parity_report",
               "--video", video, "--frames", str(args.frames),
               "--encoder", encoder, "--encoder_path", ckpt,
               "--input_size", str(args.input_size),
               "--device", args.device, "--compute_dtype", dtype]
        if golden["calibrated"]:
            # the SBS parity run must use the derived scaler on both sides:
            # with the shipped one the plane table would clip at the step cap
            cmd += ["--depth_scaler", repr(golden["scaler_used"])]
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
        row["parity_tail"] = proc.stdout.strip().splitlines()[-1:]
        if proc.returncode and proc.stderr.strip():
            row["parity_stderr"] = proc.stderr.strip().splitlines()[-5:]
        ok = (proc.returncode == 0 and golden["depth_ok"]
              and golden["under_step_cap"])
        row["status"] = "PASS" if ok else "FAIL"
        rows.append(row)
        print(json.dumps(row), flush=True)

    artifact = {"device": args.device, "compute_dtype": dtype, "rows": rows,
                "all_pass": all(r["status"] == "PASS" for r in rows
                                if not r["status"].startswith("SKIP"))
                and any(r["status"] == "PASS" for r in rows)}
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(f"wrote {args.out}: "
          f"{'PASS' if artifact['all_pass'] else 'INCOMPLETE/FAIL'}")
    return 0 if artifact["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
