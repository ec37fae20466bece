"""Segment processing loop (PyTorch).

Mirrors vr_video_generator_tpu/runtime/segment.py `process_segment`:

  * decode runs on a background thread into a bounded queue (two
    batches, or a whole chunk);
  * each batch is uploaded through a pinned host buffer and its step is
    enqueued on the device without waiting;
  * with ``run_cfg.chunk_batches`` k > 1, consecutive full batches gather
    in a chunk buffer, and a chunk of k goes to the device as one
    ``step_many`` (one CUDA graph replay on the card), uploaded as one
    (k, B, H, W, 3) stack and read back as one (k B, H, 2W, 3) buffer;
    a chunk of 1 goes to ``step``;
  * the SBS of dispatch i is copied into a pinned host buffer with
    ``non_blocking=True`` right after it, and read back (waiting on a CUDA
    event) only after dispatch i+1 has been enqueued, so the copy and the
    host-side encode of dispatch i overlap the device compute of i+1;
  * the short last batch is padded by repeating its last frame, flushes the
    chunk buffer and runs alone through ``step``, and only the real frames
    count toward the overflow tally (``n_valid``);
  * with ``depth_stride`` > 1, every ``stride_audit_every``-th full batch
    is a probe: the chunk buffer is flushed first, and the probe runs
    alone. With ``stride_max_rms`` 0 the probe is observe-only (the
    read-only ``stride_audit``, then ``step``); otherwise the stride is
    adaptive: probes run ``step_audited`` (full depth), a probe whose rms
    exceeds the threshold drops the loop to full depth (every batch through
    ``step_audited``, never a chunk) until the error stays at or under it
    for ``stride_hold`` batches. Each audit of a full batch is logged
    (``stride_audit_line``), as are the drops and re-raises.

The reader and writer are duck-typed: ``.height``, ``.width``,
``.read_into(frame) -> bool`` on the reader, ``.write_clip(begin, frames)``
and ``.wait()`` on the writer.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vr_video_generator_tpu_torch.utils.logging import (ProgressMeter, WorkerLog,
                                                  record_overflow,
                                                  stride_audit_line)
from vr_video_generator_tpu_torch.pipeline import SbsPipeline
# StageTimer lives in utils/profiling.py, as in the JAX package; it is
# re-exported here for the callers that import it from the segment loop.
from vr_video_generator_tpu_torch.utils.profiling import StageTimer

__all__ = ["EmitWindow", "HostStaging", "StageTimer", "process_segment"]


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
    when the shape or the dtype changes (a packed SBS batch is uint32). A
    chunk goes up as one (k, B, H, W, 3) stack and comes back as one
    (k B, ...) buffer. On the CPU it passes tensors through."""

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

    def upload(self, batch: Union[np.ndarray, Sequence[np.ndarray]]
               ) -> torch.Tensor:
        """One (B, H, W, 3) batch, or a list of k batches as one (k, B, H,
        W, 3) stack, on the device."""
        if not self.cuda:
            return torch.from_numpy(batch if isinstance(batch, np.ndarray)
                                    else np.stack(batch))
        shape = (batch.shape if isinstance(batch, np.ndarray)
                 else (len(batch),) + batch[0].shape)
        key = self._slot("up", shape, torch.uint8)
        host = self._bufs[key].numpy()
        if isinstance(batch, np.ndarray):
            host[...] = batch
        else:
            for i, b in enumerate(batch):
                host[i] = b
        dev = self._bufs[key].to(self.device, non_blocking=True)
        self._record(key)
        return dev

    def start_readback(self, sbs: Union[torch.Tensor, Tuple[torch.Tensor, ...]]):
        """Start copying one SBS tensor, or a chunk's k of them into one
        buffer, to the host; returns the handle ``finish_readback`` takes."""
        if not self.cuda:
            return sbs
        parts = (sbs,) if isinstance(sbs, torch.Tensor) else sbs
        rows = parts[0].shape[0]
        shape = (rows * len(parts),) + tuple(parts[0].shape[1:])
        key = self._slot("down", shape, parts[0].dtype)
        for i, part in enumerate(parts):
            self._bufs[key][i * rows:(i + 1) * rows].copy_(part,
                                                           non_blocking=True)
        self._record(key)
        return key

    def finish_readback(self, handle) -> np.ndarray:
        if not self.cuda:
            if isinstance(handle, torch.Tensor):
                return handle.numpy()
            return torch.cat(handle).numpy()
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

    # Chunked dispatch (RunConfig.chunk_batches): consecutive full batches
    # gather in a chunk and go to the device as one step_many. The decoder
    # may run a whole chunk ahead, so a chunk is ready when the device
    # finishes the one before it.
    chunk_k = max(1, pipeline.run_cfg.chunk_batches)
    batches: "queue.Queue" = queue.Queue(maxsize=max(2, chunk_k))
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
    prev = None  # (readback handle, real frame count) of the last dispatch
    window = EmitWindow(discard_first, end - begin)
    chunk: List[np.ndarray] = []

    def flush(force: bool) -> None:
        nonlocal pending, clip_begin
        while len(pending) >= max_frame_count or (force and pending):
            part, pending = pending[:max_frame_count], pending[max_frame_count:]
            writer.write_clip(clip_begin, part)
            clip_begin += len(part)

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

    def dispatch(group: List[np.ndarray], n_real: int,
                 audited: bool = False) -> Optional[Tuple[float, float]]:
        """Enqueue one batch (``step``, with ``n_valid``; with ``audited``
        ``step_audited``, whose stats it returns) or a chunk of full batches
        (``step_many``), start its readback, then read back the previous
        dispatch."""
        nonlocal state, prev
        stats = None
        with timer.stage("device_dispatch"):
            if audited:
                sbs, state, *stats = pipeline.step_audited(
                    staging.upload(group[0]), state, n_valid=n_real)
            elif len(group) == 1:
                sbs, state = pipeline.step(staging.upload(group[0]), state,
                                           n_valid=n_real)
            else:
                sbs, state = pipeline.step_many(staging.upload(group), state)
            handle = staging.start_readback(sbs)
        readback_prev()
        prev = (handle, n_real)
        return stats

    def dispatch_chunk() -> None:
        nonlocal chunk
        if chunk:
            dispatch(chunk, len(chunk) * batch_size)
            chunk = []

    # The stride audit (RunConfig.stride_audit_every) and the adaptive
    # stride (stride_max_rms > 0; probes every 8 batches unless set).
    run_cfg = pipeline.run_cfg
    stride = run_cfg.depth_stride
    cap = pipeline.spec.cfg.limit_step_cap
    adaptive = stride > 1 and run_cfg.stride_max_rms > 0
    audit_every = run_cfg.stride_audit_every
    if adaptive and audit_every <= 0:
        audit_every = 8
    audit_on = stride > 1 and audit_every > 0
    mode_full, hold, batch_idx = False, 0, 0

    while True:
        with timer.stage("decode_wait"):
            batch = batches.get()
        if batch is None:
            dispatch_chunk()
            break
        if isinstance(batch, BaseException):
            raise RuntimeError(f"decode thread crashed at frame "
                               f"{stream_base + frames_done}") from batch
        n_real = batch.shape[0]
        lo = stream_base + frames_done
        # Audits observe full batches only: padded copies skew the stats.
        probe = (audit_on and n_real == batch_size
                 and batch_idx % audit_every == 0)
        if n_real == batch_size and not probe and not mode_full:
            chunk.append(batch)
            next_is_probe = audit_on and (batch_idx + 1) % audit_every == 0
            if len(chunk) == chunk_k or next_is_probe:
                dispatch_chunk()
        else:
            # The short last batch, padded, a probe, or a full-depth batch:
            # the chunk is flushed first and the batch runs alone.
            if n_real < batch_size:
                pad = np.repeat(batch[-1:], batch_size - n_real, axis=0)
                batch = np.concatenate([batch, pad], axis=0)
            dispatch_chunk()
            if adaptive and (mode_full or probe):
                rms, mx = dispatch([batch], n_real, audited=True)
                if n_real == batch_size:
                    log.write(stride_audit_line(lo, lo + n_real, rms, mx,
                                                cap))
                    if rms > run_cfg.stride_max_rms:
                        if not mode_full:
                            log.write(f"adaptive stride: dropped to full "
                                      f"depth at frame {lo} (rms {rms:.4f} "
                                      f"> {run_cfg.stride_max_rms})")
                        mode_full = True
                        hold = max(1, run_cfg.stride_hold)
                    elif mode_full:
                        hold -= 1
                        if hold <= 0:
                            mode_full = False
                            log.write(f"adaptive stride: re-raised to "
                                      f"stride {stride} at frame "
                                      f"{lo + n_real} (rms {rms:.4f} <= "
                                      f"{run_cfg.stride_max_rms})")
            else:
                if probe:  # observe-only: read-only, before the step
                    with timer.stage("stride_audit"):
                        rms, mx = pipeline.stride_audit(
                            staging.upload(batch), state)
                    log.write(stride_audit_line(lo, lo + n_real, rms, mx,
                                                cap))
                dispatch([batch], n_real)
        frames_done += n_real
        batch_idx += 1
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
