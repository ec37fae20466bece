"""Run orchestration (PyTorch): repair modes, halo warm-up, the absolute
stride anchor grid, combine, and check-and-repair.

Mirrors vr_video_generator_tpu/runtime/orchestrator.py `convert_range`,
`run` and `check_and_repair`; with ``cfg.mesh_shape`` set a range goes to
the sharded runtime (``runtime/sharded_runner.py``, one contiguous segment
per data slot), as in the JAX package:

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
    stride 1 this is all identity. With ``cfg.mesh_shape`` set (and no
    ``pipeline``) the range goes to the sharded runtime."""
    from vr_video_generator_tpu_torch.video.reader import VideoReader, probe_video
    from vr_video_generator_tpu_torch.video.writer import (SubclipWriter,
                                                     get_ffmpeg_config)

    fps, video_length, width, height = probe_video(cfg.video_dir)
    end = min(end, video_length)
    if end <= begin:
        return 0
    if cfg.mesh_shape is not None and pipeline is None:
        return _convert_range_sharded(cfg, begin, end, width, height,
                                      allow_random=allow_random, log=log,
                                      device=device)
    if pipeline is not None and not isinstance(pipeline, SbsPipeline):
        # a sharded pipeline in the single-device loop would read its batch
        # as n_data separate temporal segments
        raise TypeError("convert_range takes a single-device SbsPipeline; "
                        "for the sharded runtime set cfg.mesh_shape and "
                        "pass pipeline=None")
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


def _convert_range_sharded(cfg: RunConfig, begin: int, end: int,
                           width: int, height: int,
                           allow_random: bool = False,
                           log: Optional[WorkerLog] = None,
                           device: str = "cuda") -> int:
    """Frames [begin, end) through ``run_sharded`` on a mesh of
    ``cfg.mesh_shape`` over every card (``device`` "cuda"), or over one
    device named D x M times (the CPU, or a card such as "cuda:0"). In a
    multi-host run (parallel/multihost.initialize) the mesh is the global
    one of every process's devices (a named device standing for this
    process's share), and this process runs the slots it owns. The model
    is built once on the CPU; each slot's replica, or each rank of its
    model group, is copied to its device. The log is
    ``sharded_p<process>.txt``."""
    import torch

    from vr_video_generator_tpu_torch.models.factory import load_model
    from vr_video_generator_tpu_torch.parallel import multihost
    from vr_video_generator_tpu_torch.parallel.mesh import make_mesh
    from vr_video_generator_tpu_torch.parallel.sharded import \
        ShardedSbsPipeline
    from vr_video_generator_tpu_torch.parallel.sharding import \
        check_model_axis
    from vr_video_generator_tpu_torch.pipeline import (check_f32_plan,
                                                       check_supported,
                                                       resolve_device)
    from vr_video_generator_tpu_torch.runtime.sharded_runner import \
        run_sharded

    check_supported(cfg)
    check_model_axis(cfg.model(), cfg.mesh_shape[1])
    dev = resolve_device(device)
    n_data, n_model = cfg.mesh_shape
    n_proc = multihost.process_count()
    # One named device (the CPU, or a card such as cuda:0) takes every
    # slot and rank of this process's share; "cuda" takes every card.
    named = [dev] * (n_data * n_model // n_proc) \
        if dev.type == "cpu" or dev.index is not None else None
    mesh = (multihost.make_global_mesh(cfg.mesh_shape, local=named,
                                       device=dev.type) if n_proc > 1
            else make_mesh(cfg.mesh_shape, device=dev.type, devices=named))
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32
    if dev.type == "cuda" and dtype == torch.float32:
        check_f32_plan(cfg, height, width)
    model = load_model(cfg.encoder, cfg.encoder_path, dtype=dtype,
                       device="cpu", allow_random=allow_random,
                       cfg=cfg.model(), tail=cfg.tail)
    pipe = ShardedSbsPipeline(model, height, width, mesh, run_cfg=cfg)
    del model
    log = log or WorkerLog(os.path.join(
        cfg.debug_dir, f"sharded_p{multihost.process_index()}.txt"))
    try:
        return run_sharded(pipe, cfg.video_dir, cfg.subclip_dir, begin, end,
                           max_frame_count=cfg.max_frame_count,
                           batch_size=cfg.batch_size, log=log,
                           reader_backend=cfg.reader_backend,
                           writer_backend=cfg.writer_backend,
                           warmup=cfg.warmup_frames,
                           overflow_path=overflow_path(cfg.debug_dir))
    except Exception as e:  # error funnel: the log and ERROR.txt
        log.error("Sharded conversion failed", e,
                  error_path=os.path.join(cfg.debug_dir, "ERROR.txt"))
        raise


def run(cfg: RunConfig, allow_random: bool = False,
        device: str = "cuda") -> None:
    """Full run with repair_mode dispatch (modes 0-3). In a multi-host run
    (parallel/multihost.py) every process converts its own slots, and
    process 0 alone clears the directories (before the others start) and
    combines (after the sharded runner's barrier: every subclip is on
    disk)."""
    from vr_video_generator_tpu_torch.parallel import multihost
    from vr_video_generator_tpu_torch.video.combine import (combine_clips,
                                                      verify_frame_count)

    first = multihost.process_index() == 0
    if first:
        create_folder_if_not_exist(cfg.debug_dir)
        create_folder_if_not_exist(cfg.subclip_dir)
        if cfg.repair_mode != 1:
            remove_all_files(cfg.debug_dir)
        if cfg.repair_mode == 0:
            remove_all_files(cfg.subclip_dir)
    multihost.barrier()
    if cfg.repair_mode in (0, 1):
        with trace(cfg.profile_dir or None):
            convert_range(cfg, cfg.start_frame, cfg.end_frame,
                          allow_random=allow_random, device=device)
        total, _ = summarize_overflow(overflow_path(cfg.debug_dir))
        if total and first:
            print_flush(overflow_message(total, cfg.encoder))
    if not first:
        return
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
    broken range. With ``cfg.mesh_shape`` set, each range goes through the
    sharded runtime, which builds its own."""
    from vr_video_generator_tpu_torch.video.check import check_subclips
    from vr_video_generator_tpu_torch.video.reader import probe_video

    issues = check_subclips(cfg.subclip_dir, remove_bad=repair)
    if repair and issues:
        if pipeline is None and cfg.mesh_shape is None:
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
