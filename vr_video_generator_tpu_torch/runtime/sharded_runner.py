"""Multi-device conversion runtime: n_data temporal segments, one step.

Mirrors vr_video_generator_tpu/runtime/sharded_runner.py on one process:
where the reference spawns Num_Workers segment processes that each own a
video slice, the host keeps n_data segment cursors (a decoder each) and
feeds one :class:`parallel.sharded.ShardedSbsPipeline` step, whose data
slot i owns one contiguous slice on its own device. Segment boundaries
(the reference's step policy), subclip naming, black-frame substitution,
the per-slot halo warm-up, the absolute stride anchor grid and the
overflow diagnostic match the JAX runner. Each slot has its own pinned
staging (``runtime.segment.HostStaging``: two slots on one device never
share a readback buffer) and its own subclip writer.

Video I/O comes from the port's ``video`` modules, imported lazily (the
reader needs cv2 or ffmpeg; the pipeline does not).
"""

from __future__ import annotations

import math
import queue
import threading
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from vr_video_generator_tpu_torch.parallel.sharded import ShardedSbsPipeline
from vr_video_generator_tpu_torch.runtime.segment import EmitWindow, HostStaging
from vr_video_generator_tpu_torch.utils.logging import (ProgressMeter,
                                                        WorkerLog,
                                                        record_overflow,
                                                        stride_audit_line)


@dataclass
class _Segment:
    begin: int
    end: int            # last written frame (exclusive)
    decode_end: int     # last decoded frame (exclusive; anchor-grid aligned)
    cursor: int
    reader: object      # video.reader.VideoReader
    writer: object      # video.writer.SubclipWriter
    staging: HostStaging
    pending: List[np.ndarray]
    clip_begin: int
    window: EmitWindow  # trims decoded outputs to [begin, end)

    def done(self) -> bool:
        return self.cursor >= self.decode_end


def partition_segments(start: int, end: int, n: int,
                       stride: int = 1) -> List[tuple]:
    """Contiguous [begin, end) slices, the reference's step policy
    (PredictAndGenerate.py:274-275): step = ceil(range / n).

    ``stride`` > 1 rounds the step up to a stride multiple, so interior
    segment begins stay on the absolute anchor grid (unaligned begins still
    work through the per-slot discard of run_sharded; this only avoids
    deciding the same frames twice). Slots past the range are empty."""
    step = max(1, math.ceil((end - start) / n))
    if stride > 1:
        step = -(-step // stride) * stride
    out = [(lo, min(lo + step, end)) for lo in range(start, end, step)]
    while len(out) < n:
        out.append((end, end))
    return out


def _primed_states(pipeline: ShardedSbsPipeline, slot_begins: List[int],
                   video_path: str, b: int, warmup: int,
                   reader_backend: str):
    """Per-slot halo warm-up: prime each data slot's temporal state on the
    frames preceding its segment (the reference resets per worker, a
    smoothing discontinuity this removes).

    Every slot is front-padded to the same k = ceil(warmup / b) whole
    batches of exactly ``warmup`` real frames (copies of its first frame
    before them) and the warm-up runs through the normal sharded step, its
    SBS discarded: slot i's state is then ``SbsPipeline.primed_state`` on
    frames [max(0, lo - warmup), lo) with ``min_batches`` = k, bit for bit.
    Slots with no preceding frames (begin 0) are reset to a true cold start
    afterwards: their all-pad window is a fixed point of the stride-1
    state, but at depth_stride > 1 it would prime ``anchor_prev`` on frame
    0, where the single-device path skips the warm-up. One process owns
    every slot, so the JAX runner's multi-host arguments (the global begins
    and the feeding through ``step_local``) fall away."""
    from vr_video_generator_tpu_torch.video.reader import VideoReader

    states = pipeline.initial_state()
    if warmup <= 0 or not any(lo > 0 for lo in slot_begins):
        return states
    k = -(-warmup // b)
    h, w = pipeline.height, pipeline.width

    def window(lo: int):
        # A lazy k*b-frame window, one batch column a step: front pads,
        # then the real preceding frames (at least one: the first).
        wu_begin = max(0, lo - warmup)
        n_real = max(lo - wu_begin, 1)
        with VideoReader(video_path, begin=wu_begin,
                         backend=reader_backend) as wr:
            it = iter(wr.frames(wu_begin, max(lo, wu_begin + 1)))
            frame = next(it)
            for _ in range(k * b - n_real):
                yield frame
            yield frame
            for _ in range(n_real - 1):
                frame = next(it, frame)  # a short read repeats the last frame
                yield frame

    gens = [window(lo) for lo in slot_begins]
    for _ in range(k):
        local = np.empty((len(slot_begins), b, h, w, 3), np.uint8)
        for slot_i, gen in enumerate(gens):
            for j in range(b):
                local[slot_i, j] = next(gen)
        _, states = pipeline.step(local.reshape(len(slot_begins) * b, h, w, 3),
                                  states)
    cold = pipeline.initial_state()
    states = [cold[i] if lo == 0 else st
              for i, (lo, st) in enumerate(zip(slot_begins, states))]
    return [st._replace(overflow=torch.zeros_like(st.overflow))
            for st in states]


def run_sharded(pipeline: ShardedSbsPipeline, video_path: str,
                subclip_dir: str, start: int, end: int,
                max_frame_count: int, batch_size: int,
                log: Optional[WorkerLog] = None,
                reader_backend: str = "auto",
                writer_backend: str = "auto",
                warmup: int = 0,
                overflow_path: Optional[str] = None) -> int:
    """Convert frames [start, end) with n_data concurrent segments; returns
    the number of frames written.

    The depth-stride anchor grid is absolute (video frame indices): at
    depth_stride s > 1 each slot processes from the aligned floor(begin /
    s) * s (and, where the video has the frames, through ceil(end / s) * s)
    and discards the extra outputs, so frame g is an anchor iff g % s == s -
    1 however the video is partitioned, and the sharded output equals the
    single-device one frame for frame."""
    from vr_video_generator_tpu_torch.video.reader import (VideoReader,
                                                           probe_video)
    from vr_video_generator_tpu_torch.video.writer import (SubclipWriter,
                                                           get_ffmpeg_config)

    log = log or WorkerLog(None)
    n_data = pipeline.n_data
    b = batch_size
    s = pipeline.depth_stride
    bounds = partition_segments(start, end, n_data, stride=s)
    # the warm-up window on the anchor grid too (a multiple of s), so its
    # front pads (k*b - n_real, with b % s == 0) never shift the phase
    warmup = -(-warmup // s) * s
    video_length = probe_video(video_path)[1]
    # Aligned decode windows; an empty slot decodes nothing (its frames
    # belong to a real slot: deciding them twice would double-count the
    # overflow diagnostic).
    proc = [(lo // s) * s if lo < hi else lo for lo, hi in bounds]
    dec_end = [min(-(-hi // s) * s, video_length) if lo < hi else lo
               for lo, hi in bounds]

    cfg = pipeline.run_cfg
    _, ffmpeg_config = get_ffmpeg_config(video_path, cfg.encoder_device) \
        if cfg.encoder_device else (None, None)
    # The JAX runner's encoder concurrency, max(Num_Workers, slots), split
    # over the slots' writers.
    per_writer = max(1, -(-max(cfg.num_workers, n_data) // n_data))
    segs: List[Optional[_Segment]] = [None] * n_data
    try:
        for i, (lo, hi) in enumerate(bounds):
            reader = VideoReader(video_path, begin=proc[i],
                                 backend=reader_backend)
            segs[i] = _Segment(
                begin=lo, end=hi, decode_end=dec_end[i], cursor=proc[i],
                reader=reader, writer=None,
                staging=HostStaging(pipeline.devices[i]), pending=[],
                clip_begin=lo, window=EmitWindow(lo - proc[i], hi - lo))
            segs[i].writer = SubclipWriter(
                subclip_dir, reader.fps, 2 * pipeline.width, pipeline.height,
                ffmpeg_config=ffmpeg_config, max_concurrent=per_writer,
                backend=writer_backend)
        return _run(pipeline, segs, video_path, proc, b, warmup,
                    reader_backend, max_frame_count, log, start, end,
                    overflow_path)
    finally:
        # SubclipWriter.close waits on its in-flight encoders
        for seg in segs:
            if seg is not None:
                seg.reader.close()
                if seg.writer is not None:
                    seg.writer.close()


def _run(pipeline: ShardedSbsPipeline, segs: List[_Segment],
         video_path: str, proc: List[int], b: int, warmup: int,
         reader_backend: str, max_frame_count: int, log: WorkerLog,
         start: int, end: int, overflow_path: Optional[str]) -> int:
    """The step loop of :func:`run_sharded` over its open segments."""
    h, w = pipeline.height, pipeline.width
    total = max(sum(seg.end - seg.begin for seg in segs), 1)
    meter = ProgressMeter(total, log)
    frames_done = 0
    # The same trip count for every slot: the longest segment decides.
    n_steps = max(-(-(e - p) // b) for p, e in
                  zip(proc, (seg.decode_end for seg in segs)))

    def flush(seg: _Segment, force: bool) -> None:
        while (len(seg.pending) >= max_frame_count
               or (force and seg.pending)):
            chunk = seg.pending[:max_frame_count]
            seg.pending = seg.pending[max_frame_count:]
            seg.writer.write_clip(seg.clip_begin, chunk)
            seg.clip_begin += len(chunk)

    def emit(handles, counts) -> None:
        """Finish one step's readbacks and route each slot's frames to its
        writer."""
        nonlocal frames_done
        for seg, handle, count in zip(segs, handles, counts):
            sbs = seg.staging.finish_readback(handle)
            if count:
                take = seg.window.take(sbs[:count])
                seg.pending.extend(take)
                seg.cursor += count
                frames_done += len(take)
                flush(seg, force=seg.done())
        meter.report(max(frames_done, 1))

    cfg = pipeline.run_cfg
    audit_on = cfg.stride_audit_every > 0 and pipeline.depth_stride > 1
    states = _primed_states(pipeline, proc, video_path, b, warmup,
                            reader_backend)
    # Decode ahead on a background thread, and read the previous step's
    # SBS back while the current one computes (runtime/segment.py's double
    # buffering).
    batches: "queue.Queue" = queue.Queue(maxsize=2)
    decoder = threading.Thread(target=_decode_steps,
                               args=(segs, b, h, w, n_steps, batches),
                               daemon=True)
    decoder.start()
    prev = None  # (readback handles, counts) of the step in flight
    for step_idx in range(n_steps):
        item = batches.get()
        if isinstance(item, BaseException):
            raise RuntimeError("sharded decode thread crashed") from item
        local, counts, starts = item
        parts = [seg.staging.upload(local[i * b:(i + 1) * b])
                 for i, seg in enumerate(segs)]
        # The sampled stride audit, on the step index (the JAX runner's
        # globally uniform trigger); a padded slot's stats are not logged.
        if audit_on and step_idx % cfg.stride_audit_every == 0:
            stats = pipeline.stride_audit(parts, states)
            for i, (rms, mx) in stats.items():
                if counts[i] == b:
                    log.write(stride_audit_line(
                        starts[i], starts[i] + b, rms, mx,
                        pipeline.spec.cfg.limit_step_cap, slot=i))
        sbs, states = pipeline.step(parts, states, counts)
        handles = [seg.staging.start_readback(out)
                   for seg, out in zip(segs, sbs)]
        if prev is not None:
            emit(*prev)
        prev = (handles, counts)
    if prev is not None:
        emit(*prev)
    decoder.join()
    for seg in segs:
        flush(seg, force=True)
    overflow = sum(int(st.overflow) for st in states)
    if overflow:
        log.write(f"WARNING: scaled depth exceeded limit_step_cap on "
                  f"{overflow} frames (clamped; check the encoder's "
                  f"depth_scaler)")
        record_overflow(overflow_path, start, end, overflow)
    log.write("Sharded runner ending")
    return frames_done


def _decode_steps(segs_owned: List[_Segment], b: int, h: int, w: int,
                  n_steps: int, out_q: "queue.Queue") -> None:
    """Background producer of the staged step batches: exactly ``n_steps``
    (local, counts, starts) tuples, then None. It keeps its own cursors
    (``_Segment.cursor`` is the emit side's). A failed frame read is a
    black frame (``VideoReader.frames``); a crash is shipped to the
    consumer, which raises."""
    cursors = [seg.cursor for seg in segs_owned]
    try:
        for _ in range(n_steps):
            local = np.empty((len(segs_owned), b, h, w, 3), np.uint8)
            counts, starts = [], []
            for slot_i, seg in enumerate(segs_owned):
                n_want = max(min(b, seg.decode_end - cursors[slot_i]), 0)
                starts.append(cursors[slot_i])
                for j, frame in enumerate(seg.reader.frames(
                        cursors[slot_i], cursors[slot_i] + n_want)):
                    local[slot_i, j] = frame
                if n_want < b:  # pad with the last frame: a fixed batch
                    local[slot_i, n_want:] = (local[slot_i, n_want - 1]
                                              if n_want else 0)
                counts.append(n_want)
                cursors[slot_i] += n_want
            out_q.put((local.reshape(len(segs_owned) * b, h, w, 3),
                       counts, starts))
        out_q.put(None)
    except BaseException as e:  # noqa: BLE001 - shipped to the consumer
        out_q.put(e)
