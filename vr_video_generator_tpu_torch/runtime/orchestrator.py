"""Run orchestration (PyTorch): repair modes 0 and 2, halo warm-up, combine.

Mirrors vr_video_generator_tpu/runtime/orchestrator.py `convert_range` and
`run` on one device:

  repair_mode 0: clear the debug and subclip dirs, convert (under a
                 torch.profiler trace with ``profile_dir``), combine
  repair_mode 2: clear the debug dir, combine existing subclips with audio

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
    ``begin`` so the range continues the full-video sequence."""
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
        init_state = None
        if cfg.warmup_frames > 0 and begin > 0:
            wu_begin = max(0, begin - cfg.warmup_frames)
            with VideoReader(cfg.video_dir, begin=wu_begin,
                             backend=cfg.reader_backend) as wr:
                warm = np.stack(list(wr.frames(wu_begin, begin)))
            init_state = pipeline.primed_state(
                warm, cfg.batch_size,
                min_batches=-(-cfg.warmup_frames // cfg.batch_size))
        with VideoReader(cfg.video_dir, begin=begin,
                         backend=cfg.reader_backend) as reader:
            return process_segment(pipeline, reader, writer, begin, end,
                                   max_frame_count=cfg.max_frame_count,
                                   batch_size=cfg.batch_size, log=log,
                                   profile_csv=profile_csv,
                                   initial_state=init_state,
                                   overflow_path=overflow_path(cfg.debug_dir))
    except Exception as e:  # error funnel: the segment log and ERROR.txt
        log.error(f"Segment {begin} failed", e,
                  error_path=os.path.join(cfg.debug_dir, "ERROR.txt"))
        raise
    finally:
        writer.close()


def run(cfg: RunConfig, allow_random: bool = False,
        device: str = "cuda") -> None:
    """Full run with repair_mode dispatch (modes 0 and 2)."""
    if cfg.repair_mode not in (0, 2):
        not_ported(f"repair_mode={cfg.repair_mode}", "repair modes 1 and 3")
    from vr_video_generator_tpu_torch.video.combine import (combine_clips,
                                                      verify_frame_count)

    create_folder_if_not_exist(cfg.debug_dir)
    create_folder_if_not_exist(cfg.subclip_dir)
    remove_all_files(cfg.debug_dir)
    if cfg.repair_mode == 0:
        remove_all_files(cfg.subclip_dir)
        with trace(cfg.profile_dir or None):
            convert_range(cfg, cfg.start_frame, cfg.end_frame,
                          allow_random=allow_random, device=device)
        total, _ = summarize_overflow(overflow_path(cfg.debug_dir))
        if total:
            print_flush(overflow_message(total, cfg.encoder))
    combine_clips(cfg.subclip_dir, cfg.video_dir, cfg.output_dir,
                  just_combine=0)
    verify_frame_count(cfg.video_dir, cfg.output_dir, verbose=True)
