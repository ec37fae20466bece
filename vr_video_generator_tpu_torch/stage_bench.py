"""Where the time goes on the port's main path, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 -m vr_video_generator_tpu_torch.stage_bench [--out DIR]

The configuration is ``bench.py`` config 2's geometry with the unfused
kernels: 1080p, vits, bf16, batch 8, ``--mlp_fused xla --tail xla``, with
numpy-seeded random weights whose depth scaler is calibrated on the first
batch (see :func:`calibrate_random_scaler`). It measures, in this order:

* ``step``: ``SbsPipeline.step`` on frames already on the device, CUDA
  events around ``STEPS`` back-to-back steps, ``REPEATS`` times;
* ``stages``: each stage of one step alone (preprocess, encoder, DPT head,
  bicubic upsample, temporal scan, warp tables, the two warp kernels),
  CUDA events, median of ``RUNS``;
* ``segment``: host-inclusive ``process_segment`` over ``FRAMES``
  in-memory frames (decode thread, pinned upload, step, readback, writer
  hand-off), wall clock, ``REPEATS`` times;
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
import subprocess
import sys
import time
from collections import defaultdict
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
    """Duck-typed subclip writer; keeps the frames only with ``keep``."""

    def __init__(self, keep: bool = True):
        self.keep = keep
        self.frames: List[np.ndarray] = []
        self.clips: List[tuple] = []

    def write_clip(self, begin: int, frames) -> None:
        self.clips.append((begin, len(frames)))
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
    from vr_video_generator_tpu_torch.ops.temporal import temporal_scan
    from vr_video_generator_tpu_torch.ops.warp import (blur_select_sbs,
                                                       warp_composite)

    model, spec = pipe.model, pipe.spec
    imgs = pipe.frames_to_device(frames)
    p = model.cfg.patch_size
    net_hw = network_input_size(H, W, target=pipe.run_cfg.input_size,
                                multiple_of=p)
    ph, pw = net_hw[0] // p, net_hw[1] // p
    layers = model.cfg.intermediate_layers

    def preprocess():
        return preprocess_frames(imgs, net_hw, dtype=model.dtype)

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
                               spec.kernel_size, spec.cfg.sigma)

    return {name: event_ms(fn) for name, fn in (
        ("preprocess", preprocess), ("encoder", encoder), ("head", head),
        ("upsample", upsample), ("temporal", temporal), ("tables", tables),
        ("warp_composite", composite), ("blur_select_sbs", blur_select))}


def run_segment(pipe, frames: np.ndarray) -> Tuple[float, Dict[str, float]]:
    """One host-inclusive ``process_segment`` over ``frames``: its seconds,
    and the seconds of each host stage of its ``StageTimer``."""
    from vr_video_generator_tpu_torch.runtime.segment import (StageTimer,
                                                              process_segment)

    timer = StageTimer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = process_segment(pipe, MemoryReader(frames), CollectingWriter(False),
                        0, len(frames), max_frame_count=15, batch_size=B,
                        timer=timer)
    torch.cuda.synchronize()
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


def traced_segment(pipe, frames: np.ndarray, out_dir: str | None,
                   top: int = 15) -> dict:
    """One ``process_segment`` under torch.profiler: the device's busy and
    idle share of the run's wall time, and the device time of the ``top``
    kernels and copies, by name."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        seconds, _ = run_segment(pipe, frames)
    trace_dir = out_dir or tempfile.mkdtemp()
    trace_path = os.path.join(trace_dir, "segment_trace.json")
    prof.export_chrome_trace(trace_path)
    with open(trace_path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
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
    else:
        os.remove(trace_path)
        os.rmdir(trace_dir)
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
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stage_bench: no CUDA device", file=sys.stderr)
        return 2
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
    cfg = RunConfig(encoder="vits", batch_size=B, compute_dtype="bfloat16",
                    mlp_fused="xla", tail="xla")
    pipe = SbsPipeline.create(cfg, H, W, allow_random=True, device="cuda",
                              seed=SEED)
    rng = np.random.default_rng(SEED)
    frames = rng.integers(0, 256, (FRAMES, H, W, 3), dtype=np.uint8)
    scaler = calibrate_random_scaler(pipe, frames[:B])
    run_segment(pipe, frames[:2 * B])  # warm-up: kernels built, buffers pinned

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
        card=card, config="1080p vits bf16 B=8 mlp_fused=xla tail=xla",
        depth_scaler=scaler,
        step_ms=step_ms, step_fps=[B * 1e3 / ms for ms in step_ms],
        stages_ms=stages, stages_sum_ms=sum(stages.values()),
        segment_frames=FRAMES, segment_s=seg_s,
        segment_fps=[FRAMES / s for s in seg_s],
        segment_host_stages_s=[st for _, st in segs], trace=trace)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
