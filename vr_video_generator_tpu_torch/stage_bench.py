"""Where the time goes on the port's main path, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 -m vr_video_generator_tpu_torch.stage_bench [--out DIR]
        [--encoder vits|vitb|vitl|vitg] [--input_size N]
        [--mlp_fused auto|fused|xla] [--tail auto|fused|xla]
        [--sbs_output auto|u8|packed] [--chunk_batches K]
        [--depth_stride S] [--compute_dtype bfloat16|float32]

The configuration is ``bench.py`` config 2's geometry: 1080p, bf16 (f32 with
``--compute_dtype float32``: the f32 kernels, at every encoder; vitg's
fused SwiGLU half on row 10's f32 chain), batch 8,
vits at --input_size 518 unless ``--encoder`` / ``--input_size`` say
otherwise, with the kernel paths the two flags pick as the CLI's do (default
``auto``: on the card the fused attention half-block and DPT tail), and
numpy-seeded random weights whose depth scaler is calibrated on the first
batch (see :func:`calibrate_random_scaler`). ``--sbs_output packed`` emits
uint32 words from the packed blur/select kernel and reads them back (4
bytes a pixel against u8's 3); the writer's host work is run (the packed
words unpacked to rgb24 by ``native.unpack_sbs``), its encode is not.
``--depth_stride S`` runs the depth net on every S-th frame of a batch (as
the CLI); its stages then run on those B/S frames, and the lerp to B frames
is one more stage. It measures, in this order:

* ``step``: ``SbsPipeline.step`` on frames already on the device, CUDA
  events around ``STEPS`` back-to-back steps, ``REPEATS`` times;
* ``stages``: each stage of one step alone (preprocess, encoder, DPT head,
  bicubic upsample, with a stride the lerp, temporal scan, warp tables,
  the two warp kernels), CUDA events, median of ``RUNS``;
* ``dispatch``: the host time of one call (after a synchronize, median of
  ``RUNS``) and the kernels it puts on the device (a torch.profiler trace
  of one call) for an eager ``step``, and with ``--chunk_batches K`` > 1
  for one ``step_many`` of K batches (a CUDA graph replay);
* ``segment``: host-inclusive ``process_segment`` over ``FRAMES``
  in-memory frames (decode thread, pinned upload, step or, with
  ``--chunk_batches K``, chunks of K through ``step_many``, readback,
  writer hand-off), wall clock, ``REPEATS`` times;
* ``trace``: one more ``process_segment`` run under ``torch.profiler``. The
  device's busy time is the union of its kernel, memcpy and memset
  intervals; its idle share is 1 - busy / the run's wall time. The
  kernels and copies are ranked by device time. ``segment`` also reports
  the host stages of ``process_segment``'s ``StageTimer``.

The last line is one JSON object with every number and the card's
``nvidia-smi`` name and power limit. With ``--out DIR`` it also writes the
Chrome trace and torch.profiler's op table there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

H, W, B = 1080, 1920, 8
FRAMES, STEPS, RUNS, REPEATS, SEED = 80, 10, 20, 3, 0
# Depth peak the random-weight net is scaled to: inside the family's
# ~[0, 14] range, so the warp has many live shifts and leaves holes.
TARGET_DEPTH_MAX = 12.0


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class MemoryReader:
    """Duck-typed video reader over frames held in memory."""

    def __init__(self, frames: np.ndarray):
        self.frames = frames
        self.height, self.width = frames.shape[1], frames.shape[2]
        self.pos = 0

    def read_into(self, out: np.ndarray) -> bool:
        out[...] = self.frames[self.pos]
        self.pos += 1
        return True


class CollectingWriter:
    """Duck-typed subclip writer; keeps the frames only with ``keep``. With
    ``unpack`` it does the host work the subclip writer does before it
    encodes: packed uint32 frames are unpacked to rgb24 (native.unpack_sbs,
    as ``video/writer.py``), u8 frames pass as they are."""

    def __init__(self, keep: bool = True, unpack: bool = False):
        self.keep, self.unpack = keep, unpack
        self.frames: List[np.ndarray] = []
        self.clips: List[tuple] = []

    def write_clip(self, begin: int, frames) -> None:
        from vr_video_generator_tpu_torch import native

        self.clips.append((begin, len(frames)))
        if self.unpack:
            frames = [native.unpack_sbs(f) if f.dtype == np.uint32 else f
                      for f in frames]
        if self.keep:
            self.frames.extend(frames)

    def wait(self) -> None:
        pass


def calibrate_random_scaler(pipe, frames: np.ndarray) -> float:
    """Random weights give a raw depth far below the family's scaled range.
    Set the depth scaler so the depth of ``frames`` peaks at
    ``TARGET_DEPTH_MAX``, as an off-family checkpoint's ``depth_scaler``
    would. Returns the new scaler."""
    raw_max = (float(pipe.depth_only(frames).max())
               / pipe.model.cfg.depth_scaler)
    scaler = TARGET_DEPTH_MAX / raw_max
    pipe.model.cfg = dataclasses.replace(pipe.model.cfg, depth_scaler=scaler)
    return scaler


def event_ms(fn: Callable[[], object]) -> float:
    """Median device time of ``fn`` in ms over ``RUNS`` runs (CUDA events),
    after three untimed runs."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def step_rate(pipe, frames: np.ndarray) -> float:
    """Device-resident ms per step: ``STEPS`` back-to-back steps on one
    batch already on the device, carrying the state."""
    batch = pipe.frames_to_device(frames)
    state = pipe.initial_state()
    pipe.step(batch, state)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(STEPS):
        _, state = pipe.step(batch, state)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / STEPS


@torch.inference_mode()
def stage_times(pipe, frames: np.ndarray) -> Dict[str, float]:
    """ms of each stage of one step, each timed alone."""
    from vr_video_generator_tpu_torch.ops.preprocess import (
        network_input_size, preprocess_frames)
    from vr_video_generator_tpu_torch.ops.resize import resize_bicubic
    from vr_video_generator_tpu_torch.ops.temporal import (stride_interpolate,
                                                           temporal_scan)
    from vr_video_generator_tpu_torch.ops.warp import (blur_select_sbs,
                                                       warp_composite)

    model, spec = pipe.model, pipe.spec
    imgs = pipe.frames_to_device(frames)
    stride = pipe.run_cfg.depth_stride
    anchors = imgs[stride - 1::stride]  # every frame at stride 1
    p = model.cfg.patch_size
    net_hw = network_input_size(H, W, target=pipe.run_cfg.input_size,
                                multiple_of=p)
    ph, pw = net_hw[0] // p, net_hw[1] // p
    layers = model.cfg.intermediate_layers

    def preprocess():
        return preprocess_frames(anchors, net_hw, dtype=model.dtype,
                                 impl=pipe.preprocess_impl)

    x = preprocess().to(model.dtype)

    def encoder():
        return model.pretrained(x, layers)

    taps = encoder()

    def head():
        return F.relu(model.depth_head(taps, ph, pw))

    raw = head().float()

    def upsample():
        return resize_bicubic(raw, (H, W), align_corners=True, h_axis=1,
                              w_axis=2) * model.cfg.depth_scaler

    depth = upsample()
    state = pipe.initial_state()
    extra = {}
    if stride > 1:
        anchor_depth = depth

        def interpolate():
            return stride_interpolate(anchor_depth, state, stride)

        extra["stride_interpolate"] = interpolate
        depth, _ = interpolate()

    def temporal():
        return temporal_scan(depth, state, spec)

    blended, ranges, _ = temporal()

    def tables():
        return spec.tables(blended, ranges)

    _, st = tables()

    def composite():
        return warp_composite(imgs, blended, st, spec.s_neg, spec.s_pos)

    comp, cov = composite()

    def blur_select():
        return blur_select_sbs(comp, cov, imgs, st.edge_width,
                               spec.kernel_size, spec.cfg.sigma,
                               emit=pipe.sbs_emit)

    return {name: event_ms(fn) for name, fn in (
        ("preprocess", preprocess), ("encoder", encoder), ("head", head),
        ("upsample", upsample), *extra.items(), ("temporal", temporal),
        ("tables", tables), ("warp_composite", composite),
        ("blur_select_sbs", blur_select))}


def host_ms(fn: Callable[[], object]) -> float:
    """Median host ms of one call of ``fn`` over ``RUNS`` calls, each after
    a synchronize: the time to enqueue, not to run (the host blocks only
    where a call fills the launch queue or waits on the device)."""
    times = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_segment(pipe, frames: np.ndarray) -> Tuple[float, Dict[str, float]]:
    """One host-inclusive ``process_segment`` over ``frames`` at the
    pipeline's batch size and ``chunk_batches``: its seconds, and the
    seconds of each host stage of its ``StageTimer``."""
    from vr_video_generator_tpu_torch.runtime.segment import (StageTimer,
                                                              process_segment)
    from vr_video_generator_tpu_torch.utils.logging import WorkerLog

    timer = StageTimer()
    # The worker log goes to a file, as the CLI's does, not to stdout.
    log = WorkerLog(os.devnull)
    _sync(pipe.device)
    t0 = time.perf_counter()
    try:
        n = process_segment(pipe, MemoryReader(frames),
                            CollectingWriter(keep=False, unpack=True), 0,
                            len(frames), max_frame_count=15,
                            batch_size=pipe.run_cfg.batch_size, log=log,
                            timer=timer)
        _sync(pipe.device)
    finally:
        log.close()
    elapsed = time.perf_counter() - t0
    if n != len(frames):
        raise RuntimeError(f"process_segment wrote {n} of {len(frames)} frames")
    return elapsed, dict(timer.totals)


def _union_us(intervals: List[tuple]) -> float:
    busy, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def traced(fn: Callable[[], object], out_dir: str | None = None,
           name: str = "trace.json"):
    """``fn()`` under ``utils.profiling.trace``, synchronized at its end:
    (its result, the Chrome trace's events, the profiler). The trace file
    stays in ``out_dir`` when one is given."""
    from vr_video_generator_tpu_torch.utils.profiling import trace

    trace_dir = out_dir or tempfile.mkdtemp()
    with trace(trace_dir, name) as prof:
        result = fn()
        torch.cuda.synchronize()
    with open(os.path.join(trace_dir, name), encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    if not out_dir:
        shutil.rmtree(trace_dir)
    return result, events, prof


def dispatch_costs(pipe, frames: np.ndarray, k: int) -> dict:
    """Host ms of one call (:func:`host_ms`) against the work it enqueues,
    for an eager ``step`` of one batch and, with ``k`` > 1, one
    ``step_many`` of k batches (a graph replay, its frames and state
    copied in and its outputs cloned out): the device kernels of one call
    (a torch.profiler trace), the CUDA runtime calls that launch or copy,
    by name, and the port's kernel launches (its LaunchCounters)."""
    from vr_video_generator_tpu_torch.kernels import (launch_counts,
                                                       reset_launch_counts)

    batch = pipe.frames_to_device(frames[:B])
    state = pipe.initial_state()
    calls = {"step": lambda: pipe.step(batch, state)}
    if k > 1:
        stack = torch.stack([batch] * k)
        calls[f"step_many k={k}"] = lambda: pipe.step_many(stack, state)
    out = {}
    for label, fn in calls.items():
        fn()  # builds, caches, the capture
        ms = host_ms(fn)
        torch.cuda.synchronize()
        reset_launch_counts()
        _, events, _ = traced(fn)
        runtime = Counter(e["name"] for e in events
                          if e.get("cat") == "cuda_runtime" and any(
                              w in e["name"] for w in ("Launch", "Memcpy",
                                                       "Memset")))
        out[label] = dict(
            batches=k if label != "step" else 1, host_ms=ms,
            device_kernels=sum(1 for e in events if e.get("cat") == "kernel"),
            runtime_calls=dict(runtime),
            port_launches={n: v for n, v in launch_counts().items() if v})
    return out


def traced_segment(pipe, frames: np.ndarray, out_dir: str | None,
                   top: int = 15) -> dict:
    """One ``process_segment`` under torch.profiler: the device's busy and
    idle share of the run's wall time, and the device time of the ``top``
    kernels and copies, by name."""
    (seconds, _), events, prof = traced(lambda: run_segment(pipe, frames),
                                        out_dir, "segment_trace.json")
    device = [e for e in events if "dur" in e and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    busy_s = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in device]) * 1e-6
    kernel_busy_s = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in device
                               if e["cat"] == "kernel"]) * 1e-6
    # Host time blocked on the device, from the CUDA runtime calls.
    waits = [e["dur"] for e in events if "dur" in e
             and e.get("cat") == "cuda_runtime" and e.get("name") in
             ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")]
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e["name"]][0] += e["dur"] * 1e-3
        by_name[e["name"]][1] += 1
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=top)
    if out_dir:
        with open(os.path.join(out_dir, "segment_ops.txt"), "w",
                  encoding="utf-8") as f:
            f.write(table)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(seconds=seconds, fps=len(frames) / seconds,
                device_busy_s=busy_s, kernel_busy_s=kernel_busy_s,
                device_idle_share=1.0 - busy_s / seconds,
                device_events=len(device), host_syncs=len(waits),
                host_sync_s=sum(waits) * 1e-6,
                top_ops=[dict(op=name, device_ms=ms, calls=n)
                         for name, (ms, n) in ops])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for the Chrome trace and the op table")
    ap.add_argument("--encoder", default="vits",
                    choices=["vits", "vitb", "vitl", "vitg"],
                    help="Depth-Anything-V2 encoder (as the CLI)")
    ap.add_argument("--input_size", type=int, default=518,
                    help="depth net input size (as the CLI)")
    ap.add_argument("--mlp_fused", default="auto",
                    choices=["auto", "fused", "xla"],
                    help="ViT half-block kernel fusion policy (as the CLI)")
    ap.add_argument("--tail", default="auto", choices=["auto", "fused", "xla"],
                    help="DPT head tail implementation (as the CLI)")
    ap.add_argument("--sbs_output", default="auto",
                    choices=["auto", "u8", "packed"],
                    help="device SBS emit (as the CLI; the warp is the "
                         "kernels' on the card)")
    ap.add_argument("--depth_stride", type=int, default=1,
                    help="run the depth net on every S-th frame (as the "
                         "CLI; must divide the batch of 8)")
    ap.add_argument("--chunk_batches", type=int, default=1,
                    help="the segment and trace phases dispatch chunks of "
                         "this many full batches through step_many (as the "
                         "CLI)")
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=["bfloat16", "float32"],
                    help="depth-net compute dtype (as the CLI)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stage_bench: no CUDA device", file=sys.stderr)
        return 2
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    print(card, flush=True)
    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
    cfg = RunConfig(encoder=opts.encoder, batch_size=B,
                    compute_dtype=opts.compute_dtype,
                    input_size=opts.input_size,
                    mlp_fused=opts.mlp_fused, tail=opts.tail,
                    sbs_output=opts.sbs_output,
                    chunk_batches=opts.chunk_batches,
                    depth_stride=opts.depth_stride)
    dt = "bf16" if opts.compute_dtype == "bfloat16" else "f32"
    label = (f"1080p {opts.encoder} --input_size {opts.input_size} {dt} B={B} "
             f"mlp_fused={opts.mlp_fused} tail={opts.tail} "
             f"sbs_output={opts.sbs_output} chunk_batches={opts.chunk_batches} "
             f"depth_stride={opts.depth_stride}")
    print(label, flush=True)
    pipe = SbsPipeline.create(cfg, H, W, allow_random=True, device="cuda",
                              seed=SEED)
    rng = np.random.default_rng(SEED)
    frames = rng.integers(0, 256, (FRAMES, H, W, 3), dtype=np.uint8)
    scaler = calibrate_random_scaler(pipe, frames[:B])
    # Warm-up: kernels built, buffers pinned; with chunks, each chunk size
    # the runs take captured.
    run_segment(pipe, frames if opts.chunk_batches > 1 else frames[:2 * B])
    dispatch = dispatch_costs(pipe, frames, opts.chunk_batches)
    launches = dispatch["step"]["port_launches"]
    print(f"launches per step: {json.dumps(launches)}", flush=True)
    print(f"dispatch: {json.dumps(dispatch)}", flush=True)

    step_ms = [step_rate(pipe, frames[:B]) for _ in range(REPEATS)]
    print(f"step: {step_ms} ms per {B}-frame step", flush=True)
    stages = stage_times(pipe, frames[:B])
    print(f"stages (ms): {json.dumps(stages)}", flush=True)
    segs = [run_segment(pipe, frames) for _ in range(REPEATS)]
    seg_s = [s for s, _ in segs]
    print(f"segment: {FRAMES} frames in {seg_s} s; host stages (s) "
          f"{json.dumps([st for _, st in segs])}", flush=True)
    trace = traced_segment(pipe, frames, opts.out)
    print(f"trace: {json.dumps({k: v for k, v in trace.items() if k != 'top_ops'})}",
          flush=True)
    for r in trace["top_ops"]:
        print(f"  {r['device_ms']:10.3f} ms  n={r['calls']:5d}  "
              f"{r['op'][:100]}", flush=True)
    print(json.dumps(dict(
        card=card, config=label, launches_per_step=launches,
        depth_scaler=scaler, dispatch=dispatch,
        step_ms=step_ms, step_fps=[B * 1e3 / ms for ms in step_ms],
        stages_ms=stages, stages_sum_ms=sum(stages.values()),
        segment_frames=FRAMES, segment_s=seg_s,
        segment_fps=[FRAMES / s for s in seg_s],
        segment_host_stages_s=[st for _, st in segs], trace=trace)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
