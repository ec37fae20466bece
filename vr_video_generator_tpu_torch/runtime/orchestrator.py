"""Run orchestration (PyTorch): repair modes, halo warm-up, the absolute
stride anchor grid, combine, and check-and-repair.

Mirrors vr_video_generator_tpu/runtime/orchestrator.py `convert_range`,
`run` and `check_and_repair` on one device:

  repair_mode 0: clear the debug and subclip dirs, convert (under a
                 torch.profiler trace with ``profile_dir``), combine
  repair_mode 1: KEEP the debug dir, convert the given range, no combine
  repair_mode 2: clear the debug dir, combine existing subclips with audio
  repair_mode 3: clear the debug dir, combine video only

Video I/O comes from the port's ``video`` modules, imported here lazily
(the reader needs cv2 or ffmpeg; the pipeline does not).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from vr_video_generator_tpu_torch.utils.config import RunConfig
from vr_video_generator_tpu_torch.utils.fsutil import (create_folder_if_not_exist,
                                                 remove_all_files)
from vr_video_generator_tpu_torch.utils.logging import (WorkerLog, overflow_message,
                                                  overflow_path, print_flush,
                                                  summarize_overflow)
from vr_video_generator_tpu_torch.utils.profiling import trace
from vr_video_generator_tpu_torch import not_ported
from vr_video_generator_tpu_torch.pipeline import SbsPipeline
from vr_video_generator_tpu_torch.runtime.segment import process_segment


def convert_range(cfg: RunConfig, begin: int, end: int,
                  pipeline: Optional[SbsPipeline] = None,
                  allow_random: bool = False,
                  log: Optional[WorkerLog] = None,
                  device: str = "cuda") -> int:
    """Convert frames [begin, end) of cfg.video_dir into subclips; the
    temporal state is primed on the ``warmup_frames`` frames before
    ``begin`` so the range continues the full-video sequence.

    With ``depth_stride`` s > 1 the anchor groups stay on the absolute
    video frame grid: processing starts at floor(begin/s)*s and, where the
    video has the frames, ends at ceil(end/s)*s, the extra outputs
    discarded, and the warm-up window is rounded up to the grid, so a
    repair range renders bit-identically to the original full run. At
    stride 1 this is all identity."""
    from vr_video_generator_tpu_torch.video.reader import VideoReader, probe_video
    from vr_video_generator_tpu_torch.video.writer import (SubclipWriter,
                                                     get_ffmpeg_config)

    if cfg.mesh_shape is not None:
        not_ported("--mesh (multi-device runs)", "sharded and multi-GPU runtime")
    fps, video_length, width, height = probe_video(cfg.video_dir)
    end = min(end, video_length)
    if end <= begin:
        return 0
    if pipeline is None:
        pipeline = SbsPipeline.create(cfg, height, width,
                                      allow_random=allow_random, device=device)
    _, ffmpeg_config = get_ffmpeg_config(cfg.video_dir, cfg.encoder_device) \
        if cfg.encoder_device else (None, None)
    writer = SubclipWriter(cfg.subclip_dir, fps, 2 * width, height,
                           ffmpeg_config=ffmpeg_config,
                           max_concurrent=max(1, cfg.num_workers),
                           backend=cfg.writer_backend)
    log = log or WorkerLog(os.path.join(cfg.debug_dir, f"segment_{begin}.txt"))
    profile_csv = os.path.join(cfg.debug_dir, f"segment_{begin}_profile.csv")
    try:
        s = cfg.depth_stride
        proc_begin = (begin // s) * s
        proc_end = min(-(-end // s) * s, video_length)
        warmup = -(-cfg.warmup_frames // s) * s
        init_state = None
        if warmup > 0 and proc_begin > 0:
            wu_begin = max(0, proc_begin - warmup)
            with VideoReader(cfg.video_dir, begin=wu_begin,
                             backend=cfg.reader_backend) as wr:
                warm = np.stack(list(wr.frames(wu_begin, proc_begin)))
            # min_batches pins the pad count (see SbsPipeline.primed_state)
            init_state = pipeline.primed_state(
                warm, cfg.batch_size,
                min_batches=-(-warmup // cfg.batch_size))
        with VideoReader(cfg.video_dir, begin=proc_begin,
                         backend=cfg.reader_backend) as reader:
            return process_segment(pipeline, reader, writer, begin, end,
                                   max_frame_count=cfg.max_frame_count,
                                   batch_size=cfg.batch_size, log=log,
                                   profile_csv=profile_csv,
                                   initial_state=init_state,
                                   discard_first=begin - proc_begin,
                                   discard_last=proc_end - end,
                                   overflow_path=overflow_path(cfg.debug_dir))
    except Exception as e:  # error funnel: the segment log and ERROR.txt
        log.error(f"Segment {begin} failed", e,
                  error_path=os.path.join(cfg.debug_dir, "ERROR.txt"))
        raise
    finally:
        writer.close()


def run(cfg: RunConfig, allow_random: bool = False,
        device: str = "cuda") -> None:
    """Full run with repair_mode dispatch (modes 0-3)."""
    from vr_video_generator_tpu_torch.video.combine import (combine_clips,
                                                      verify_frame_count)

    create_folder_if_not_exist(cfg.debug_dir)
    create_folder_if_not_exist(cfg.subclip_dir)
    if cfg.repair_mode != 1:
        remove_all_files(cfg.debug_dir)
    if cfg.repair_mode == 0:
        remove_all_files(cfg.subclip_dir)
    if cfg.repair_mode in (0, 1):
        with trace(cfg.profile_dir or None):
            convert_range(cfg, cfg.start_frame, cfg.end_frame,
                          allow_random=allow_random, device=device)
        total, _ = summarize_overflow(overflow_path(cfg.debug_dir))
        if total:
            print_flush(overflow_message(total, cfg.encoder))
    if cfg.repair_mode in (0, 2, 3):
        combine_clips(cfg.subclip_dir, cfg.video_dir, cfg.output_dir,
                      just_combine=int(cfg.repair_mode == 3))
        verify_frame_count(cfg.video_dir, cfg.output_dir, verbose=True)


def check_and_repair(cfg: RunConfig, repair: bool = True,
                     allow_random: bool = False,
                     pipeline: Optional[SbsPipeline] = None,
                     device: str = "cuda") -> list:
    """Check the subclips (``video.check.check_subclips``) and, with
    ``repair``, remove the bad ones and convert exactly their ranges again,
    all through one pipeline: ``pipeline``, or one built at the first
    broken range."""
    from vr_video_generator_tpu_torch.video.check import check_subclips
    from vr_video_generator_tpu_torch.video.reader import probe_video

    issues = check_subclips(cfg.subclip_dir, remove_bad=repair)
    if repair and issues:
        if pipeline is None:
            _, _, width, height = probe_video(cfg.video_dir)
            pipeline = SbsPipeline.create(cfg, height, width,
                                          allow_random=allow_random,
                                          device=device)
        for issue in issues:
            lo, hi = issue.repair_range
            convert_range(cfg, lo, hi, pipeline=pipeline,
                          allow_random=allow_random, device=device)
        total, _ = summarize_overflow(overflow_path(cfg.debug_dir))
        if total:
            print_flush(overflow_message(total, cfg.encoder))
    return issues
