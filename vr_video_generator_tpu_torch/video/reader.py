"""Video decode tier — host side of the pipeline.

Parity surface: the reference decodes with ``cv2.VideoCapture`` + frame seek
(reference SupportFunction.py:170-177) and probes duration via ffprobe
(:43-49). Backends here:

  * cv2 (always available, frame-accurate seek);
  * ffmpeg rawvideo stdout pipe — higher throughput for 4K sources.
    Frame-exact at any start: seeking uses a ``select=gte(n\\,begin)``
    filter (decode-and-discard by decode-order frame number), never a
    timestamp ``-ss``, so the subclip/repair frame contract holds for
    arbitrary GOP structures.

``backend="auto"`` picks ffmpeg when a binary is discoverable and the read
starts at frame 0 (pure streaming — no seek cost); otherwise cv2, whose
native seek beats ffmpeg's decode-and-discard for deep starts.

Frames are delivered as RGB uint8 HWC (the reference decodes BGR and swaps
channels at PredictAndGenerate.py:227-231; we swap once at the decode
boundary instead).

The port's own copy of vr_video_generator_tpu/video/reader.py, kept in step
with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Iterator, Optional, Tuple

import cv2
import numpy as np

from vr_video_generator_tpu_torch import native

# Native host-I/O tier (C++, GIL-free): builds on first use; falls back to
# numpy when no toolchain exists. Resolved lazily so importing this module
# never triggers a compile.
_native_ok: Optional[bool] = None


def native_available() -> bool:
    global _native_ok
    if _native_ok is None:
        _native_ok = native.available()
    return _native_ok


def find_binary(name: str) -> Optional[str]:
    """Locate ffmpeg/ffprobe: env override (VRVG_FFMPEG/VRVG_FFPROBE — the
    project's knob prefix), vendored ./ffmpeg dir (the reference's layout,
    README.md:43), then PATH."""
    env = os.environ.get(f"VRVG_{name.upper()}")
    if env and os.path.exists(env):
        return env
    vendored = os.path.join(".", "ffmpeg", name)
    if os.path.exists(vendored):
        return vendored
    return shutil.which(name)


def probe_video(path: str) -> Tuple[float, int, int, int]:
    """(fps, frame_count, width, height) — reference load_and_set_video
    (SupportFunction.py:170-177) without keeping the capture open.

    Fails fast on a missing file: cv2 would silently report 0 frames and the
    pipeline would only fail much later at the combine step.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(f"video not found: {path!r}")
    cap = cv2.VideoCapture(path)
    try:
        fps = cap.get(cv2.CAP_PROP_FPS)
        frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    finally:
        cap.release()
    return fps, frames, width, height


def get_length(path: str) -> float:
    """Duration in seconds — ffprobe when available (reference
    SupportFunction.py:43-49), else frame_count/fps."""
    ffprobe = find_binary("ffprobe")
    if ffprobe:
        result = subprocess.run(
            [ffprobe, "-v", "error", "-show_entries", "format=duration",
             "-of", "default=noprint_wrappers=1:nokey=1", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        try:
            return float(result.stdout.decode().strip())
        except ValueError:
            pass
    fps, frames, _, _ = probe_video(path)
    return frames / fps if fps else 0.0


def pick_auto_backend(begin: int, ffmpeg_path: Optional[str]) -> str:
    """Backend policy for ``backend="auto"``: ffmpeg only for begin=0
    streaming (its frame-exact seek is decode-and-discard, so cv2's native
    seek wins for mid-video starts)."""
    return "ffmpeg" if ffmpeg_path and begin == 0 else "cv2"


class VideoReader:
    """Sequential RGB frame reader starting at an arbitrary frame index."""

    def __init__(self, path: str, begin: int = 0, backend: str = "auto"):
        self.path = path
        self.fps, self.frame_count, self.width, self.height = probe_video(path)
        self._proc = None
        self._cap = None
        if backend == "auto":
            backend = pick_auto_backend(begin, find_binary("ffmpeg"))
        self.backend = backend
        if backend == "cv2":
            self._cap = cv2.VideoCapture(path)
            if begin:
                self._cap.set(cv2.CAP_PROP_POS_FRAMES, begin)
        elif backend == "ffmpeg":
            ffmpeg = find_binary("ffmpeg")
            if not ffmpeg:
                raise RuntimeError("ffmpeg binary not found for ffmpeg backend")
            args = [ffmpeg, "-v", "error", "-i", path]
            # Pin the output frame size to the probed dimensions: a
            # mid-stream resolution change would otherwise misframe every
            # subsequent fixed-size pipe read into sheared garbage. The
            # rgb24 request already inserts swscale, so the explicit size
            # merges into that conversion (no extra pass, no pixel change
            # at the normal constant-size case — the ffmpeg==cv2 parity
            # test runs through this filter).
            vf = f"scale={self.width}:{self.height}"
            if begin:
                # Frame-exact seek: a timestamp -ss lands on GOP-dependent
                # frames (reference seeks frame-exactly via cv2,
                # SupportFunction.py:170-177); select on the decode-order
                # frame counter instead. Dropped frames never cross the pipe.
                vf = f"select=gte(n\\,{begin})," + vf
                args += ["-vsync", "0"]
            args += ["-vf", vf, "-f", "rawvideo", "-pix_fmt", "rgb24", "-"]
            self._proc = subprocess.Popen(args, stdout=subprocess.PIPE,
                                          bufsize=self.width * self.height * 3 * 4)
        else:
            raise ValueError(f"unknown reader backend {backend!r}")

    def read(self) -> Optional[np.ndarray]:
        """Next RGB uint8 frame, or None on decode failure / EOF (the caller
        substitutes black frames, matching reference :222-225)."""
        out = np.empty((self.height, self.width, 3), np.uint8)
        return out if self.read_into(out) else None

    def read_into(self, out: np.ndarray) -> bool:
        """Decode the next frame directly into a preallocated (H, W, 3) uint8
        buffer (e.g. one row of the device_put staging batch) — the zero-copy
        host path. Uses the native tier (GIL-free read_full / bgr_to_rgb)
        when available. Returns False on decode failure / EOF."""
        if self._cap is not None:
            ok, bgr = self._cap.read()
            if not ok or bgr is None:
                return False
            if (native_available() and bgr.flags.c_contiguous
                    and out.flags.c_contiguous and bgr.shape == out.shape):
                # shape equality is load-bearing: the native swizzle writes
                # src.size bytes blindly, so a decoded frame that disagrees
                # with the probe dimensions (mid-stream resolution change)
                # must take the numpy path, which raises instead of
                # overrunning the staging batch row.
                native.bgr_to_rgb(bgr, out)
            else:
                out[:] = bgr[:, :, ::-1]
            return True
        n = self.width * self.height * 3
        if native_available() and out.flags.c_contiguous:
            got = native.read_full(self._proc.stdout.fileno(), out.reshape(-1))
            return got == n
        raw = self._proc.stdout.read(n)
        if len(raw) < n:
            return False
        out.reshape(-1)[:] = np.frombuffer(raw, np.uint8)
        return True

    def frames(self, begin: int, end: int) -> Iterator[np.ndarray]:
        """Frames [begin, end): decode failures become black frames."""
        for i in range(begin, end):
            frame = self.read()
            if frame is None:
                frame = np.zeros((self.height, self.width, 3), np.uint8)
            yield frame

    def close(self) -> None:
        if self._cap is not None:
            self._cap.release()
            self._cap = None
        if self._proc is not None:
            self._proc.stdout.close()
            self._proc.terminate()
            try:
                # reap: terminate() alone leaves a zombie per reader (one is
                # opened per segment, warm-up window, and repair range)
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
            self._proc = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
