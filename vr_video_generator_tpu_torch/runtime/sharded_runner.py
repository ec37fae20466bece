"""Multi-device conversion runtime: n_data temporal segments, one step.

Mirrors vr_video_generator_tpu/runtime/sharded_runner.py: where the
reference spawns Num_Workers segment processes that each own a video slice,
the host keeps a segment cursor (a decoder each) for every data slot this
process owns and feeds one :class:`parallel.sharded.ShardedSbsPipeline`
step, whose data slot i owns one contiguous slice on its own device (or
model group). Segment boundaries (the reference's step policy), subclip
naming, black-frame substitution, the per-slot halo warm-up, the absolute
stride anchor grid and the overflow diagnostic match the JAX runner. Each
slot has its own pinned staging (``runtime.segment.HostStaging``: two slots
on one device never share a readback buffer) and its own subclip writer.

Multi-host (parallel/multihost.py): every process runs the same step count
over the global partition but decodes, steps (``step_local``) and encodes
only its own slots, and waits at a barrier before it returns, so that
process 0's combine sees every subclip.

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

from vr_video_generator_tpu_torch.parallel.multihost import barrier
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
                   reader_backend: str, any_preceding: bool,
                   global_begins: List[int]):
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
    0, where the single-device path skips the warm-up.

    ``slot_begins`` are this process's slots' begins; ``any_preceding`` and
    ``global_begins`` come from every slot of the mesh, as the JAX runner
    requires (there the warm-up steps launch one program across every
    process). Here a process's steps touch only its own slots, so the
    global decision gives each slot the state a per-process one would."""
    from vr_video_generator_tpu_torch.video.reader import VideoReader

    states = pipeline.initial_state()
    if warmup <= 0 or not any_preceding:
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
        _, states = pipeline.step_local(
            local.reshape(len(slot_begins) * b, h, w, 3), states)
    cold = pipeline.initial_state()
    states = [cold[pos] if global_begins[i] == 0 else st
              for pos, (i, st) in enumerate(zip(pipeline.local_slots,
                                                states))]
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
    the number of frames this process wrote.

    Multi-host aware: every process runs the same step count, but decodes
    and encodes only the data slots it owns (``pipeline.local_slots``) and
    feeds them through ``step_local``; one process owning every slot is
    the single-host run.

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
    s = pipeline.depth_stride
    bounds = partition_segments(start, end, pipeline.n_data, stride=s)
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
    owned = pipeline.local_slots
    # The JAX runner's encoder concurrency, max(Num_Workers, owned slots),
    # split over the slots' writers.
    per_writer = max(1, -(-max(cfg.num_workers, len(owned)) // len(owned)))
    segs: List[_Segment] = []
    try:
        for i, dev in zip(owned, pipeline.devices):
            lo, hi = bounds[i]
            reader = VideoReader(video_path, begin=proc[i],
                                 backend=reader_backend)
            segs.append(_Segment(
                begin=lo, end=hi, decode_end=dec_end[i], cursor=proc[i],
                reader=reader, writer=None, staging=HostStaging(dev),
                pending=[], clip_begin=lo,
                window=EmitWindow(lo - proc[i], hi - lo)))
            segs[-1].writer = SubclipWriter(
                subclip_dir, reader.fps, 2 * pipeline.width, pipeline.height,
                ffmpeg_config=ffmpeg_config, max_concurrent=per_writer,
                backend=writer_backend)
        done = _run(pipeline, segs, video_path, proc, dec_end, batch_size,
                    warmup, reader_backend, max_frame_count, log, start, end,
                    overflow_path)
    finally:
        # SubclipWriter.close waits on its in-flight encoders
        for seg in segs:
            seg.reader.close()
            if seg.writer is not None:
                seg.writer.close()
    # every process's subclips are on disk before any process returns
    barrier()
    return done


class _MemoryReader:
    """The reader of :func:`run_frames`: frames [lo, hi) of an array."""

    def __init__(self, frames: np.ndarray):
        self._frames = frames

    def frames(self, lo: int, hi: int):
        yield from self._frames[lo:hi]


def run_frames(pipeline: ShardedSbsPipeline, frames: np.ndarray,
               batch_size: int, writers: List, max_frame_count: int = 15,
               log: Optional[WorkerLog] = None) -> int:
    """:func:`run_sharded`'s step loop over in-memory frames (the video
    [0, len(frames)), stride 1, no warm-up), this process's k-th slot's
    subclips handed to ``writers[k]`` (``write_clip(begin, frames)``): the
    host-inclusive sharded run without a decoder or an encoder, as
    ``bench --sharded`` times it. Returns the frames written."""
    if pipeline.depth_stride != 1:
        raise ValueError("run_frames runs at depth_stride 1")
    n = len(frames)
    bounds = partition_segments(0, n, pipeline.n_data)
    segs = [_Segment(begin=lo, end=hi, decode_end=hi, cursor=lo,
                     reader=_MemoryReader(frames), writer=writer,
                     staging=HostStaging(dev), pending=[], clip_begin=lo,
                     window=EmitWindow(0, hi - lo))
            for (lo, hi), dev, writer in zip(
                [bounds[i] for i in pipeline.local_slots], pipeline.devices,
                writers)]
    return _run(pipeline, segs, "", [lo for lo, _ in bounds],
                [hi for _, hi in bounds], batch_size, 0, "auto",
                max_frame_count, log or WorkerLog(None), 0, n, None)


def _run(pipeline: ShardedSbsPipeline, segs: List[_Segment],
         video_path: str, proc: List[int], dec_end: List[int], b: int,
         warmup: int, reader_backend: str, max_frame_count: int,
         log: WorkerLog, start: int, end: int,
         overflow_path: Optional[str]) -> int:
    """The step loop of :func:`run_sharded` over this process's open
    segments (``segs``, one a slot of ``pipeline.local_slots``); ``proc``
    and ``dec_end``: every slot's decode window."""
    h, w = pipeline.height, pipeline.width
    total = max(sum(seg.end - seg.begin for seg in segs), 1)
    meter = ProgressMeter(total, log)
    frames_done = 0
    # The same trip count for every slot of every process: the longest
    # segment anywhere decides.
    n_steps = max(-(-(e - p) // b) for p, e in zip(proc, dec_end))

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
    owned = pipeline.local_slots
    states = _primed_states(pipeline, [proc[i] for i in owned], video_path,
                            b, warmup, reader_backend,
                            any_preceding=any(p > 0 for p in proc),
                            global_begins=proc)
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
        parts = [seg.staging.upload(local[k * b:(k + 1) * b])
                 for k, seg in enumerate(segs)]
        # The sampled stride audit, on the global step index (the JAX
        # runner's uniform trigger); a padded slot's stats are not logged.
        if audit_on and step_idx % cfg.stride_audit_every == 0:
            stats = pipeline.stride_audit_local(parts, states)
            for k, i in enumerate(owned):
                if counts[k] == b:
                    rms, mx = stats[i]
                    log.write(stride_audit_line(
                        starts[k], starts[k] + b, rms, mx,
                        pipeline.spec.cfg.limit_step_cap, slot=i))
        sbs, states = pipeline.step_local(parts, states, counts)
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
    # this process's slots' total (multi-host: each process records its own)
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
