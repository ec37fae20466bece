"""Generate the endurance-soak source video: long, 1080p, structured.

The counterpart of scripts/soak_gen.py, the same generator. The content is
synthetic but not trivial for the pipeline: a rolling gradient background
(a global pan, so a moving depth field) and three foreground blocks moving
at different speeds (distinct depth planes, occlusion churn). Low entropy
keeps the file and the generation time small (~10 KiB a frame, against
~600 for noise). cv2 (mp4v) writes it.

Usage: python3 -m vr_video_generator_tpu_torch.soak_gen OUT.mp4 [n_frames] [HxW]
(HxW e.g. 2160x3840 for a 4K soak; default 1080x1920)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

H, W, FPS = 1080, 1920, 30.0


def generate(path: str, n_frames: int, h: int = H, w: int = W) -> None:
    import cv2

    yy, xx = np.mgrid[0:h, 0:w]
    bg = np.stack([(xx * 255 // w), (yy * 255 // h),
                   ((xx + yy) * 127 // (h + w))], axis=-1).astype(np.uint8)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS,
                             (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter failed to open {path}")
    t0 = time.time()
    sy, sx = h / H, w / W  # the blocks' geometry scales with the frame
    try:
        for i in range(n_frames):
            f = np.roll(bg, (i * 5) % w, axis=1)
            for k, sp in enumerate((3, 7, 13)):
                x = int((i * sp * sx + k * 500 * sx) % (w - 200 * sx))
                y = int((150 + k * 250) * sy)
                f[y:y + int(180 * sy), x:x + int(200 * sx)] = \
                    (40 * k + 60, 220 - 60 * k, 30 + 70 * k)
            writer.write(f)
            if i and i % 10000 == 0:
                dt = time.time() - t0
                print(f"{i}/{n_frames} frames, {i / dt:.0f} fps gen, "
                      f"{os.path.getsize(path) / 2**20:.0f} MiB", flush=True)
    finally:
        writer.release()
    print(f"done: {n_frames} frames in {time.time() - t0:.0f}s, "
          f"{os.path.getsize(path) / 2**30:.2f} GiB", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__.strip().splitlines()[-2], file=sys.stderr)
        return 2
    n = int(argv[1]) if len(argv) > 1 else 100_000
    hh, ww = ((int(v) for v in argv[2].split("x")) if len(argv) > 2
              else (H, W))
    generate(argv[0], n, hh, ww)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
