"""Compare the warp implementations (xla / pallas / scan) on one device.

The counterpart of scripts/perf_compare.py. For each impl it times one pass
of the warp stage from a cold temporal state, ``temporal_scan`` then
``WarpSpec.warp_batch``, on seeded frames and depth x 9, with
``utils.benchlib.device_time`` (checksum-chained calls, CUDA events on the
card), and prints ``"<impl>: <ms>/frame (<fps> fps)"``, one line per impl.

On the card it runs 1080 x 1920, B = 8, chains of 4; with ``--device cpu``
216 x 384, B = 2, chains of 2, without ``pallas`` (the kernels run only on
the card). A failing impl raises: no failure is printed and passed over.

Run from the root of a checkout:

    python3 -m vr_video_generator_tpu_torch.perf_compare [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

IMPLS = ("xla", "pallas", "scan")


def compare(device: str = "cuda") -> List[str]:
    """The output lines, one per impl run on ``device``."""
    from vr_video_generator_tpu_torch.ops.temporal import (TemporalState,
                                                            temporal_scan)
    from vr_video_generator_tpu_torch.ops.warp import WarpSpec
    from vr_video_generator_tpu_torch.pipeline import resolve_device
    from vr_video_generator_tpu_torch.utils.benchlib import device_time
    from vr_video_generator_tpu_torch.utils.config import StereoConfig

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    h, w, b = (1080, 1920, 8) if on_card else (216, 384, 2)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(
        rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(dev)
    depth = torch.from_numpy(
        rng.random((b, h, w), dtype=np.float32) * 9.0).to(dev)

    lines = []
    for impl in IMPLS:
        if impl == "pallas" and not on_card:
            continue
        spec = WarpSpec.create(h, w, StereoConfig(), impl=impl, device=dev)

        @torch.inference_mode()
        def run(frames, depth):
            state = TemporalState.initial(h, w, dev)
            blended, ranges, _ = temporal_scan(depth, state, spec)
            return spec.warp_batch(frames, blended, ranges)

        per_call, _ = device_time(run, frames, depth, k=4 if on_card else 2)
        lines.append(f"{impl:7s}: {per_call / b * 1000:.2f} ms/frame "
                     f"({b / per_call:.1f} fps)")
        print(lines[-1], flush=True)
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    compare(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
