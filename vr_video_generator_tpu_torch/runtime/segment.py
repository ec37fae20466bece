"""Segment processing loop (PyTorch), depth_stride 1 and chunk 1.

Mirrors vr_video_generator_tpu/runtime/segment.py `process_segment`:

  * decode runs on a background thread into a bounded queue;
  * each batch is uploaded through a pinned host buffer and its step is
    enqueued on the device without waiting;
  * the SBS of batch i is copied into a pinned host buffer with
    ``non_blocking=True`` right after its step, and read back (waiting on a
    CUDA event) only after batch i+1 has been enqueued, so the copy and the
    host-side encode of batch i overlap the device compute of batch i+1;
  * the short last batch is padded by repeating its last frame, and only
    the real frames count toward the overflow tally (``n_valid``).

The reader and writer are duck-typed: ``.height``, ``.width``,
``.read_into(frame) -> bool`` on the reader, ``.write_clip(begin, frames)``
and ``.wait()`` on the writer.
"""

from __future__ import annotations

import contextlib
import csv
import os
import queue
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from vr_video_generator_tpu_torch.utils.logging import (ProgressMeter, WorkerLog,
                                                  record_overflow)
from vr_video_generator_tpu_torch.pipeline import SbsPipeline


class StageTimer:
    """Wall-clock per named stage, dumped in the JAX package's CSV schema."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.hits: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.hits[name] += 1

    def dump_csv(self, filename: str) -> None:
        file_exists = os.path.exists(filename)
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        with open(filename, "a", newline="", encoding="utf-8") as f:
            writer = csv.writer(f)
            if not file_exists:
                writer.writerow(["Function", "Line #", "Line Content",
                                 "Hits", "Total Time (µs)", "Per Hit (µs)"])
            for name in sorted(self.totals):
                total_us = self.totals[name] * 1e6
                hits = self.hits[name]
                writer.writerow([name, 0, "", hits, f"{total_us:.0f}",
                                 f"{total_us / max(hits, 1):.2f}"])


def _decode_batches(reader, begin: int, end: int, batch_size: int,
                    out_q: "queue.Queue") -> None:
    """Decode frames [begin, end) into (batch, H, W, 3) arrays; a failed
    frame read becomes a black frame, a decoder crash is shipped to the
    consumer."""
    h, w = reader.height, reader.width
    try:
        i = begin
        while i < end:
            n = min(batch_size, end - i)
            batch = np.empty((n, h, w, 3), np.uint8)
            for k in range(n):
                if not reader.read_into(batch[k]):
                    batch[k] = 0
            out_q.put(batch)
            i += n
        out_q.put(None)
    except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
        out_q.put(e)


class EmitWindow:
    """Drops the ``discard`` leading frames of the output stream and caps
    emission at ``budget`` frames."""

    def __init__(self, discard: int, budget: int):
        self.discard, self.budget = discard, budget

    def take(self, frames):
        if self.discard:
            drop = min(self.discard, len(frames))
            self.discard -= drop
            frames = frames[drop:]
        if len(frames) > self.budget:
            frames = frames[:self.budget]
        self.budget -= len(frames)
        return frames


class HostStaging:
    """Pinned host buffers for uploads and readbacks on a CUDA device: two
    per direction, each reused only after the event recorded behind its
    last copy has completed, and allocated anew, in the tensor's own dtype,
    when the shape or the dtype changes (a packed SBS batch is uint32). On
    the CPU it passes tensors through."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self._bufs: Dict[tuple, torch.Tensor] = {}
        self._events: Dict[tuple, torch.cuda.Event] = {}
        self._turn = {"up": 0, "down": 0}

    def _slot(self, direction: str, shape, dtype: torch.dtype) -> tuple:
        i = self._turn[direction]
        self._turn[direction] ^= 1
        key = (direction, i)
        buf = self._bufs.get(key)
        if buf is None or tuple(buf.shape) != tuple(shape) \
                or buf.dtype != dtype:
            self._bufs[key] = torch.empty(tuple(shape), dtype=dtype,
                                          pin_memory=self.cuda)
        elif key in self._events:
            self._events[key].synchronize()
        return key

    def _record(self, key: tuple) -> None:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._events[key] = ev

    def upload(self, batch: np.ndarray) -> torch.Tensor:
        if not self.cuda:
            return torch.from_numpy(batch)
        key = self._slot("up", batch.shape, torch.uint8)
        buf = self._bufs[key]
        buf.numpy()[...] = batch
        dev = buf.to(self.device, non_blocking=True)
        self._record(key)
        return dev

    def start_readback(self, sbs: torch.Tensor):
        if not self.cuda:
            return sbs
        key = self._slot("down", sbs.shape, sbs.dtype)
        self._bufs[key].copy_(sbs, non_blocking=True)
        self._record(key)
        return key

    def finish_readback(self, handle) -> np.ndarray:
        if not self.cuda:
            return handle.numpy()
        self._events[handle].synchronize()
        return self._bufs[handle].numpy().copy()


def process_segment(pipeline: SbsPipeline, reader, writer, begin: int,
                    end: int, max_frame_count: int, batch_size: int = 8,
                    log: Optional[WorkerLog] = None, report_every: int = 1,
                    timer: Optional[StageTimer] = None,
                    profile_csv: Optional[str] = None,
                    initial_state=None, discard_first: int = 0,
                    discard_last: int = 0,
                    overflow_path: Optional[str] = None) -> int:
    """Convert frames [begin, end); returns the number of frames written.

    ``discard_first`` / ``discard_last``: decode and process that many
    extra frames before ``begin`` / after ``end`` (the reader must be open
    at begin - discard_first) and drop their outputs.
    """
    timer = timer or StageTimer()
    log = log or WorkerLog(None)
    stream_base = begin - discard_first
    decode_end = end + discard_last
    meter = ProgressMeter(decode_end - stream_base, log)
    log.write(f"Worker begin from {begin} to {end}")

    batches: "queue.Queue" = queue.Queue(maxsize=2)
    decoder = threading.Thread(target=_decode_batches,
                               args=(reader, stream_base, decode_end,
                                     batch_size, batches),
                               daemon=True)
    decoder.start()

    staging = HostStaging(pipeline.device)
    state = (initial_state if initial_state is not None
             else pipeline.initial_state())
    pending: List[np.ndarray] = []
    clip_begin = begin
    frames_done = 0
    prev = None  # (readback handle, real frame count) of the last batch
    window = EmitWindow(discard_first, end - begin)

    def flush(force: bool) -> None:
        nonlocal pending, clip_begin
        while len(pending) >= max_frame_count or (force and pending):
            chunk, pending = pending[:max_frame_count], pending[max_frame_count:]
            writer.write_clip(clip_begin, chunk)
            clip_begin += len(chunk)

    def readback_prev() -> None:
        nonlocal prev
        if prev is None:
            return
        handle, n_prev = prev
        with timer.stage("device_readback"):
            host = staging.finish_readback(handle)
        pending.extend(window.take(host[:n_prev]))
        with timer.stage("encode"):
            flush(force=False)
        prev = None

    while True:
        with timer.stage("decode_wait"):
            batch = batches.get()
        if batch is None:
            break
        if isinstance(batch, BaseException):
            raise RuntimeError(f"decode thread crashed at frame "
                               f"{stream_base + frames_done}") from batch
        n_real = batch.shape[0]
        if n_real < batch_size:
            pad = np.repeat(batch[-1:], batch_size - n_real, axis=0)
            batch = np.concatenate([batch, pad], axis=0)
        with timer.stage("device_dispatch"):
            sbs, state = pipeline.step(staging.upload(batch), state,
                                       n_valid=n_real)
            handle = staging.start_readback(sbs)
        readback_prev()
        prev = (handle, n_real)
        frames_done += n_real
        if frames_done % (batch_size * report_every) == 0:
            meter.report(frames_done)

    readback_prev()
    with timer.stage("encode"):
        flush(force=True)
        writer.wait()
    decoder.join()
    meter.report(max(frames_done, 1))
    overflow = int(state.overflow)
    if overflow:
        log.write(f"WARNING: scaled depth exceeded limit_step_cap on "
                  f"{overflow} frames (clamped; check the encoder's "
                  f"depth_scaler)")
        record_overflow(overflow_path, begin, end, overflow)
    if profile_csv:
        timer.dump_csv(profile_csv)
    log.write("Worker ending")
    return (end - begin) - window.budget
