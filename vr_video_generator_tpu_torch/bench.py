"""The port's headline benchmark: SBS conversion throughput on one GPU.

Run from the root of a checkout:

    python3 -m vr_video_generator_tpu_torch.bench [--config N]
        [--chunk_batches K] [--depth_stride S] [--device cuda|cpu]
        [--sharded DxM] [--compute_dtype bfloat16|float32]

The counterpart of the root ``bench.py``, at its configurations (``CONFIGS``,
a copy of its table): the encoder, geometry, batch and offset step of
config N (default 2: vits, 1080p, batch 8), bf16, ``--input_size`` 518,
numpy-seeded random weights with the depth scaler calibrated on the first
batch (``stage_bench.calibrate_random_scaler``), and the CLI's defaults
otherwise (``--mlp_fused auto --tail auto``, u8 output, PyTorch's own
numeric settings). ``--depth_stride S`` runs the depth net on every S-th
frame (as the root bench's flag; the metric gets ``_stride<S>``); a config
whose batch S does not divide is skipped with a message.
``--compute_dtype float32`` runs the depth net in f32 (the f32 kernels; the
metric gets ``_f32``) at every config: 2 (vits ``auto``: rows 1, 5, 2, 6, 7
at f32), 3 (vitb: rows 1, 5, 2, 6, 9, 11 and 12) and 4, 5 (vitl: rows 1, 2,
9, the tail unfused); bf16 is the default on the card. ``--device cpu``
shrinks to the root bench's smoke geometry (vits, 270 x 480, input 126,
batch max(2, S), f32) and its two steps a chain. It measures two rates:

* device-resident frames/s: ``--steps`` chained steps on one batch already
  on the device, its SBS and state feeding a device checksum that the next
  step's frames depend on (``utils.benchlib.device_time``), CUDA events,
  best of ``--reps``; with ``--chunk_batches K`` > 1 the steps go K at a
  time through ``SbsPipeline.step_many`` (one CUDA graph replay on the
  card), otherwise through ``step``;
* host-inclusive frames/s: ``process_segment`` over ``--segment_batches``
  batches of in-memory frames at the same ``chunk_batches``
  (``stage_bench.run_segment``: decode thread, pinned upload, dispatch,
  readback, the writer's hand-off, no encode), best of ``--reps``, after a
  warm-up run that builds the kernels and captures the graphs.

It prints one JSON line: ``{"metric": "torch_sbs_fps_<h>p_<encoder>",
"value": <device-resident>, "unit": "frames/s", "vs_baseline": <value /
12>, "host_fps": <host-inclusive>, "chunk_batches": K, "card": "<name,
power limit>"}`` and the runs behind both rates; ``card`` is nvidia-smi's
line on the card and null with ``--device cpu``. The baseline is the
reference's ~12 frames/s at 1080p (the root bench's ``BASELINE_FPS``).

``--sharded DxM`` (the root bench's ``_run_sharded``) measures the sharded
runtime instead (``parallel.sharded.ShardedSbsPipeline`` on a D x M mesh of
every card, D data slots each a model group of M cards, or of D x M ``cpu``
devices with ``--device cpu``): the device-resident rate, D batches a
step, one a slot, chained and timed as above with a checksum and a pair of
CUDA events on each slot's first device (the slowest slot's time), and the
host-inclusive rate, ``runtime.sharded_runner.run_frames`` over
``--segment_batches`` batches a slot (the runner's decode thread, uploads,
dispatch round, readbacks and writers' hand-off, no codec; stride 1
only), in the metric
``torch_sbs_fps_<h>p_<encoder>_sharded_mesh<D>x<M>[_stride<S>]`` plus
``_in<size>`` and ``_<mlp_fused>`` where ``--input_size`` or
``--mlp_fused`` change the config's (``--encoder`` replaces its encoder). At 1x1 it runs
the single-device step through the sharded layer, as the root bench does
on one chip.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

# (encoder, height, width, batch, offset_step_size) per config: the root
# bench.py's table.
CONFIGS = {
    1: ("vits", 480, 854, 8, 2),
    2: ("vits", 1080, 1920, 8, 1),
    3: ("vitb", 1080, 1920, 8, 1),
    4: ("vitl", 1440, 2560, 4, 1),
    5: ("vitl", 2160, 3840, 4, 1),
}
BASELINE_FPS = 12.0
SEED = 0


class Chain:
    """One link of the device-resident chain: a step (k = 1) or a
    ``step_many`` of k batches, carrying the state from call to call."""

    def __init__(self, pipe, k: int):
        self.pipe, self.k = pipe, k
        self.state = pipe.initial_state()

    def __call__(self, frames: torch.Tensor):
        if self.k == 1:
            sbs, self.state = self.pipe.step(frames, self.state)
        else:
            sbs, self.state = self.pipe.step_many(frames, self.state)
        return sbs, self.state


def _dtype_tag(compute_dtype, on_card: bool):
    """(the RunConfig's compute dtype, the metric's suffix): bf16 on the
    card and f32 on the CPU unless named; ``_f32`` where f32 was named."""
    dtype = compute_dtype or ("bfloat16" if on_card else "float32")
    return dtype, "_f32" if compute_dtype == "float32" else ""


def run_config(config: int, chunk_batches: int = 1, device: str = "cuda",
               steps: int = 0, reps: int = 6, segment_batches: int = 12,
               depth_stride: int = 1, compute_dtype=None) -> dict:
    """The JSON line of one configuration; ``steps`` 0 is 8 on the card
    and 2 on the CPU, rounded up to whole chunks; ``compute_dtype`` None is
    bf16 on the card, f32 on the CPU."""
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline
    from vr_video_generator_tpu_torch.stage_bench import (
        calibrate_random_scaler, card_line, run_segment)
    from vr_video_generator_tpu_torch.utils.benchlib import device_time

    on_card = torch.device(device).type == "cuda"
    encoder, h, w, b, step = CONFIGS[config]
    if not on_card:
        encoder, h, w, b = "vits", 270, 480, max(2, depth_stride)
    dtype, dtag = _dtype_tag(compute_dtype, on_card)
    cfg = RunConfig(encoder=encoder, batch_size=b, offset_step_size=step,
                    input_size=518 if on_card else 126, compute_dtype=dtype,
                    chunk_batches=chunk_batches, depth_stride=depth_stride)
    pipe = SbsPipeline.create(cfg, h, w, allow_random=True, device=device,
                              seed=SEED)
    frames = np.random.default_rng(SEED).integers(
        0, 256, (segment_batches * b, h, w, 3), dtype=np.uint8)
    calibrate_random_scaler(pipe, frames[:b])

    k = chunk_batches
    calls = -(-(steps or (8 if on_card else 2)) // k)
    batch = pipe.frames_to_device(frames[:b])
    chain_in = batch if k == 1 else torch.stack([batch] * k)
    per_call, _ = device_time(Chain(pipe, k), chain_in, k=calls, reps=reps)
    fps = k * b / per_call

    run_segment(pipe, frames)  # warm-up: kernels built, graphs captured
    host = [len(frames) / run_segment(pipe, frames)[0] for _ in range(reps)]
    tag = dtag + (f"_stride{depth_stride}" if depth_stride > 1 else "")
    return {"metric": f"torch_sbs_fps_{h}p_{encoder}{tag}", "value": fps,
            "unit": "frames/s", "vs_baseline": fps / BASELINE_FPS,
            "host_fps": max(host), "chunk_batches": k,
            "depth_stride": depth_stride, "compute_dtype": dtype,
            "card": card_line() if on_card else None,
            "config": config, "device": str(pipe.device),
            "steps": calls * k, "reps": reps,
            "device_resident_s_per_frame": per_call / (k * b),
            "host_frames": len(frames), "host_fps_runs": host}


def sharded_device_time(pipe, parts, k: int, reps: int) -> float:
    """Best seconds per sharded step over ``reps`` chains of ``k`` steps, the
    chain of :func:`utils.benchlib.device_time` kept per slot: each slot's
    SBS and state feed a checksum on its device that its next frames depend
    on. On the card each slot's chain is timed by CUDA events on its device
    and a chain takes its slowest slot's time; on the CPU, the host clock."""
    import time

    from vr_video_generator_tpu_torch.parallel.sharded import device_scope
    from vr_video_generator_tpu_torch.utils.benchlib import checksum, poison

    cuda = parts[0].device.type == "cuda"
    states = pipe.initial_state()

    def run(n_calls: int):
        nonlocal states
        css = [torch.zeros((), device=p.device) for p in parts]
        inputs = list(parts)
        for _ in range(n_calls):
            sbs, states = pipe.step(inputs, states)
            for i, dev in enumerate(pipe.devices):
                with device_scope(dev):
                    css[i] = css[i] + checksum((sbs[i], states[i]))
            inputs = [poison(p, cs) for p, cs in zip(parts, css)]
        return css

    [float(cs) for cs in run(1)]  # warm-up: builds, caches, graph capture
    best = float("inf")
    for _ in range(reps):
        if cuda:
            events = []
            for dev in pipe.devices:
                torch.cuda.synchronize(dev)
            for dev in pipe.devices:
                with device_scope(dev):
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                    events.append(start)
            css = run(k)
            for i, dev in enumerate(pipe.devices):
                with device_scope(dev):
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    events[i] = (events[i], end)
            [float(cs) for cs in css]
            seconds = max(a.elapsed_time(b) for a, b in events) * 1e-3
        else:
            t0 = time.perf_counter()
            [float(cs) for cs in run(k)]
            seconds = time.perf_counter() - t0
        best = min(best, seconds)
    return best / k


def sharded_host_fps(pipe, frames: np.ndarray, b: int, reps: int
                     ) -> list:
    """Host-inclusive frames/s of the sharded runtime, ``reps`` runs:
    ``runtime.sharded_runner.run_frames`` over ``frames`` (each slot its
    contiguous share: the decode thread, each slot's pinned upload, the
    dispatch round, the readbacks, the writers' hand-off, no codec), after a
    warm-up run."""
    import time

    from vr_video_generator_tpu_torch.runtime.sharded_runner import run_frames
    from vr_video_generator_tpu_torch.stage_bench import CollectingWriter
    from vr_video_generator_tpu_torch.utils.logging import WorkerLog

    def once() -> float:
        for dev in pipe.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        log = WorkerLog(os.devnull)
        t0 = time.perf_counter()
        try:
            n = run_frames(pipe, frames, b,
                           [CollectingWriter(keep=False, unpack=True)
                            for _ in pipe.devices], log=log)
        finally:
            log.close()
        for dev in pipe.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        if n != len(frames):
            raise RuntimeError(f"run_frames wrote {n} of {len(frames)} "
                               "frames")
        return len(frames) / (time.perf_counter() - t0)

    once()  # warm-up: kernels built, graphs captured
    return [once() for _ in range(reps)]


def run_sharded_config(config: int, mesh_shape, device: str = "cuda",
                       steps: int = 0, reps: int = 6,
                       depth_stride: int = 1, compute_dtype=None,
                       segment_batches: int = 12, encoder=None,
                       input_size=None, mlp_fused: str = "auto") -> dict:
    """The JSON line of one configuration through the sharded step on a
    ``mesh_shape`` mesh; ``steps`` as in :func:`run_config`. ``encoder``,
    ``input_size`` and ``mlp_fused`` override the config's (the metric
    names each one); the host-inclusive rate runs
    ``segment_batches`` batches a slot (stride 1 only)."""
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.parallel.mesh import make_mesh
    from vr_video_generator_tpu_torch.parallel.sharded import \
        ShardedSbsPipeline
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline
    from vr_video_generator_tpu_torch.stage_bench import (
        calibrate_random_scaler, card_line)

    on_card = torch.device(device).type == "cuda"
    d, m = mesh_shape
    mesh = make_mesh(mesh_shape, device=device,
                     devices=None if on_card else ["cpu"] * (d * m))
    enc, h, w, b, step = CONFIGS[config]
    size = 518 if on_card else 126
    if not on_card:
        enc, h, w, b = "vits", 270, 480, max(2, depth_stride)
    enc, size = encoder or enc, input_size or size
    dtype, dtag = _dtype_tag(compute_dtype, on_card)
    cfg = RunConfig(encoder=enc, batch_size=b, offset_step_size=step,
                    input_size=size, compute_dtype=dtype,
                    depth_stride=depth_stride, mlp_fused=mlp_fused,
                    mesh_shape=tuple(mesh_shape))
    single = SbsPipeline.create(cfg, h, w, allow_random=True,
                                device=mesh.data_devices[0], seed=SEED)
    frames = np.random.default_rng(SEED).integers(
        0, 256, (d * b * max(segment_batches, 1), h, w, 3), dtype=np.uint8)
    calibrate_random_scaler(single, frames[:b])
    pipe = ShardedSbsPipeline(single.model, h, w, mesh, run_cfg=cfg)
    del single
    parts = [torch.from_numpy(frames[i * b:(i + 1) * b]).to(dev)
             for i, dev in enumerate(pipe.devices)]
    calls = steps or (8 if on_card else 2)
    per_step = sharded_device_time(pipe, parts, calls, reps)
    fps = d * b / per_step
    host = (sharded_host_fps(pipe, frames, b, reps)
            if depth_stride == 1 and segment_batches > 0 else None)
    tag = dtag + (f"_stride{depth_stride}" if depth_stride > 1 else "") \
        + (f"_in{input_size}" if input_size else "") \
        + (f"_{mlp_fused}" if mlp_fused != "auto" else "")
    return {"metric": f"torch_sbs_fps_{h}p_{enc}_sharded_mesh{d}x{m}{tag}",
            "value": fps, "unit": "frames/s",
            "vs_baseline": fps / BASELINE_FPS,
            "host_fps": max(host) if host else None,
            "mesh": [d, m], "depth_stride": depth_stride,
            "encoder": enc, "input_size": size, "mlp_fused": mlp_fused,
            "card": card_line() if on_card else None, "config": config,
            "devices": [str(dev) for dev in pipe.devices],
            "steps": calls, "reps": reps,
            "device_resident_s_per_frame": per_step / (d * b),
            "host_frames": len(frames) if host else 0,
            "host_fps_runs": host}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", type=int, default=2, choices=sorted(CONFIGS))
    ap.add_argument("--chunk_batches", type=int, default=1,
                    help="steps a step_many call takes (1: step)")
    ap.add_argument("--depth_stride", type=int, default=1,
                    help="run the depth net on every S-th frame (1: every "
                         "frame)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu runs the root bench's smoke geometry")
    ap.add_argument("--steps", type=int, default=0,
                    help="chained steps a timed chain (0: 8 on the card, "
                         "2 on the CPU)")
    ap.add_argument("--reps", type=int, default=6,
                    help="timed repeats of each rate; the best is reported")
    ap.add_argument("--segment_batches", type=int, default=12,
                    help="batches of frames the host-inclusive run takes")
    ap.add_argument("--sharded", type=str, default="",
                    help="DxM: time the sharded runtime on a D x M mesh of "
                         "every card (D data slots of M-card model groups)")
    ap.add_argument("--encoder", default=None,
                    choices=["vits", "vitb", "vitl", "vitg"],
                    help="with --sharded: the config's encoder replaced")
    ap.add_argument("--input_size", type=int, default=None,
                    help="with --sharded: the depth net's input size "
                         "(default 518)")
    ap.add_argument("--mlp_fused", default="auto",
                    choices=["auto", "fused", "xla"],
                    help="with --sharded: the ViT half-block fusion policy")
    ap.add_argument("--compute_dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="depth-net dtype (default: bfloat16 on the card, "
                         "float32 on the CPU); float32 adds _f32 to the "
                         "metric")
    opts = ap.parse_args(argv)
    if opts.chunk_batches < 1:
        ap.error("--chunk_batches must be >= 1")
    if opts.depth_stride < 1:
        ap.error("--depth_stride must be >= 1")
    batch = CONFIGS[opts.config][3]
    if opts.device == "cuda" and batch % opts.depth_stride:
        print(f"config {opts.config}: skipped: depth_stride "
              f"{opts.depth_stride} does not divide its batch {batch}",
              file=sys.stderr)
        return 0
    if opts.sharded:
        mesh_shape = tuple(int(v) for v in
                           opts.sharded.replace("x", ",").split(","))
        if len(mesh_shape) != 2:
            ap.error(f"--sharded takes DxM, got {opts.sharded!r}")
        line = run_sharded_config(opts.config, mesh_shape, opts.device,
                                  opts.steps, opts.reps, opts.depth_stride,
                                  opts.compute_dtype, opts.segment_batches,
                                  opts.encoder, opts.input_size,
                                  opts.mlp_fused)
    else:
        line = run_config(opts.config, opts.chunk_batches, opts.device,
                          opts.steps, opts.reps, opts.segment_batches,
                          opts.depth_stride, opts.compute_dtype)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
