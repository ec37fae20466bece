"""Video encode tier: subclip writers with the reference's filename contract.

Subclips named ``{begin}_{end}.mp4`` (END INCLUSIVE) in the subclip dir are
the pipeline's unit of checkpointing (reference PredictAndGenerate.py:243,
SURVEY.md §5 checkpoint/resume). Encoding backends:

  * ffmpeg rawvideo-stdin subprocess, argv parity with
    reference SupportFunction.py:181-216 (same rgb24 pipe, same libopenh264
    bitrate ladder / hevc_nvenc flags);
  * cv2.VideoWriter fallback when no ffmpeg binary exists (tests, bare hosts).

Like the reference (:241-246), the previous encoder process is awaited
before a new one starts, so encoding overlaps the next batch's compute.

The port's own copy of vr_video_generator_tpu/video/writer.py, kept in step
with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
import subprocess
from typing import List, Optional, Sequence

import cv2
import numpy as np

from vr_video_generator_tpu_torch import native
from vr_video_generator_tpu_torch.video.reader import (find_binary, native_available,
                                                 probe_video)


def get_ffmpeg_config(video_path: str, device: str = "cpu") -> tuple[int, list]:
    """(video_length, ffmpeg argv prefix) — parity with reference
    get_ffmpeg_config (SupportFunction.py:181-216): rawvideo rgb24 stdin at
    double width, -an, yuv420p; libopenh264 5M CBR on cpu / hevc_nvenc cq29
    p7 on nvidia."""
    fps, video_length, width, height = probe_video(video_path)
    ffmpeg = find_binary("ffmpeg") or "ffmpeg"
    config = [
        ffmpeg, "-y",
        "-f", "rawvideo", "-vcodec", "rawvideo", "-pix_fmt", "rgb24",
        "-s", f"{2 * width}x{height}", "-r", str(fps),
        "-i", "-", "-an", "-pix_fmt", "yuv420p",
    ]
    if device == "cpu":
        config += ["-c:v", "libopenh264", "-b:v", "5M",
                   "-maxrate", "10M", "-bufsize", "20M"]
    elif device == "nvidia":
        config += ["-c:v", "hevc_nvenc", "-cq", "29", "-rc", "vbr",
                   "-preset", "p7", "-multipass", "0", "-tune", "5"]
    return video_length, config


class SubclipWriter:
    """Writes batches of SBS frames as ``{begin}_{end}.mp4`` subclips."""

    def __init__(self, subclip_dir: str, fps: float, width: int, height: int,
                 ffmpeg_config: Optional[List[str]] = None, backend: str = "auto",
                 max_concurrent: int = 1):
        os.makedirs(subclip_dir, exist_ok=True)
        self.subclip_dir = subclip_dir
        self.fps, self.width, self.height = fps, width, height
        # Up to max_concurrent encoder subprocesses in flight — the host-tier
        # analog of the reference's Num_Workers segment-encode parallelism
        # (each reference worker owned one ffmpeg pipe).
        self.max_concurrent = max(1, max_concurrent)
        self._procs: List[subprocess.Popen] = []
        if backend == "auto":
            backend = "ffmpeg" if find_binary("ffmpeg") else "cv2"
        elif backend == "ffmpeg" and ffmpeg_config is None \
                and not find_binary("ffmpeg"):
            # fail at construction like VideoReader, not with an opaque
            # Popen TypeError after the first batch is already computed
            raise RuntimeError("ffmpeg binary not found for ffmpeg writer "
                               "backend")
        self.backend = backend
        self.ffmpeg_config = ffmpeg_config

    def _path(self, begin: int, end_inclusive: int) -> str:
        return os.path.join(self.subclip_dir, f"{begin}_{end_inclusive}.mp4")

    def _rgb24(self, frame: np.ndarray) -> np.ndarray:
        """Accept either uint8 HWC frames or the device's packed-uint32 SBS
        rows (r|g<<8|b<<16 — ops/warp_pallas blur_select_sbs_pallas) and
        return rgb24; native byte-strip when the C++ tier is built."""
        if frame.dtype != np.uint32:
            return frame
        assert frame.ndim == 2, "packed SBS frames must be 2D (H, 2W) uint32"
        if native_available():
            if (getattr(self, "_unpack_buf", None) is None
                    or self._unpack_buf.shape[:2] != frame.shape):
                self._unpack_buf = np.empty((*frame.shape, 3), np.uint8)
            return native.unpack_sbs(frame, out=self._unpack_buf)
        return native.unpack_sbs_np(frame)

    def write_clip(self, begin: int, frames: Sequence[np.ndarray]) -> str:
        """Write frames [begin, begin+len) as one subclip; returns its path."""
        end_inclusive = begin + len(frames) - 1
        path = self._path(begin, end_inclusive)
        if self.backend == "ffmpeg":
            # Reference semantics with max_concurrent=1: wait for the previous
            # encoder before starting the next (:241-242).
            while len(self._procs) >= self.max_concurrent:
                self._reap(self._procs.pop(0))
            config = self.ffmpeg_config
            if config is None:
                ffmpeg = find_binary("ffmpeg")
                config = [ffmpeg, "-y", "-f", "rawvideo", "-vcodec", "rawvideo",
                          "-pix_fmt", "rgb24", "-s", f"{self.width}x{self.height}",
                          "-r", str(self.fps), "-i", "-", "-an",
                          "-pix_fmt", "yuv420p", "-c:v", "libopenh264",
                          "-b:v", "5M", "-maxrate", "10M", "-bufsize", "20M"]
            proc = subprocess.Popen(config + [path], stdin=subprocess.PIPE,
                                    stderr=subprocess.DEVNULL)
            try:
                if native_available():
                    # GIL-free EINTR-safe fd writes; frames coming off the
                    # device readback are contiguous batch rows, so this path
                    # is zero-copy (no .tobytes() allocation per frame) for
                    # uint8 and one native byte-strip for packed-uint32 SBS.
                    fd = proc.stdin.fileno()
                    for frame in frames:
                        if native.write_full(fd, self._rgb24(frame)) < 0:
                            raise BrokenPipeError(
                                f"encoder pipe write failed: {path}")
                else:
                    for frame in frames:
                        frame = self._rgb24(frame)
                        proc.stdin.write(np.ascontiguousarray(frame).tobytes())
                proc.stdin.close()
            except BaseException:
                # don't leak a stdin-blocked encoder into the error path;
                # close() flushes, and flushing into a dead encoder raises
                # BrokenPipeError AGAIN — which must not skip the kill/reap
                try:
                    proc.stdin.close()
                except OSError:
                    pass
                proc.kill()
                proc.wait()
                raise
            self._procs.append(proc)
        else:
            writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                     self.fps, (self.width, self.height))
            if not writer.isOpened():
                raise RuntimeError(f"cv2.VideoWriter failed to open {path}")
            for frame in frames:
                frame = self._rgb24(frame)
                writer.write(np.ascontiguousarray(frame[:, :, ::-1]))  # RGB->BGR
            writer.release()
        return path

    def _reap(self, proc: subprocess.Popen) -> None:
        """Wait for an encoder and REFUSE a nonzero exit: a failed encode
        (disk full at finalize, unwritable path, codec error) used to pass
        silently — the run completed 'successfully' around a truncated
        subclip that only verify_frame_count's printed diff would hint at."""
        if proc.wait() != 0:
            raise subprocess.CalledProcessError(proc.returncode, proc.args)

    def wait(self) -> None:
        while self._procs:
            self._reap(self._procs.pop(0))

    def close(self) -> None:
        self.wait()
