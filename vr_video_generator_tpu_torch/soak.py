"""Endurance soak: a long CLI conversion on the card, instrumented.

The counterpart of scripts/soak.py, with its two modes, its flags (plus
``--device``), its artifact keys and its PASS rules. The reference's worst
production scars were slow leaks over hours-long runs; this shows whether
memory stays flat and the subclip cadence steady over a long run:

  * the CLI mode runs the port's ``cli.main`` on a long source
    (``soak_gen`` makes one), repair_mode 0: convert and combine, with
    ``--allow_random_weights``. A sampler thread records the host RSS of
    this process and its subprocess tree (the encoders), the device memory
    and the subclip count every few seconds. ffmpeg I/O goes through real
    subprocesses: the host's ffmpeg where there is one, else the
    behavioural double (tests/fakes/ffmpeg_double.py, found from the root
    of the checkout) in spool mode, so that the encoders drain stdin as
    real ffmpeg does. Afterwards the subclip checker and the post-combine
    frame count must come back clean: PASS needs rc 0, no checker issue and
    a frame-count difference of 0;
  * ``--device_only N`` loops the pipeline's ``step`` (``step_many`` with
    ``--chunk_batches`` > 1) over N frames of 8 rotating real-content
    batches kept on the card, the SBS left there, a scalar checksum read
    back every few batches to bound the queue. PASS needs every frame done
    and the device memory at the end within max(start x 1.05, start + 64
    MiB).

Device memory is sampled two ways: ``torch.cuda.memory_allocated`` (the
caching allocator's live tensors; ``allocated_mb``) and the card's used
bytes, total - free from ``torch.cuda.mem_get_info`` (``device_mb``). Only
the second sees the kernels' own workspaces and the allocator's reserve,
and the flatness rule reads it. On the CPU both are null. Each run writes
one artifact JSON (``--out``). The JAX script's TPU-relay and compile-cache
set-up calls have no job on the card and are left out.

Usage:
    python3 -m vr_video_generator_tpu_torch.soak_gen /tmp/soak/in.mp4 100000
    python3 -m vr_video_generator_tpu_torch.soak --video /tmp/soak/in.mp4 \\
        --workdir /tmp/soak --out SOAK.json [--device_only N]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import threading
import time
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _install_double(workdir: str) -> str:
    """Point VRVG_FFMPEG/VRVG_FFPROBE at the behavioural double (spool
    mode)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tests.fakes.ffmpeg_double import install_shims

    ffmpeg, ffprobe = install_shims(os.path.join(workdir, "ffbin"))
    os.environ["VRVG_FFMPEG"] = ffmpeg
    os.environ["VRVG_FFPROBE"] = ffprobe
    os.environ["FAKE_FFMPEG_SPOOL"] = "1"
    return "behavioral double (spool mode)"


def _tree_rss_mb(root_pid: int) -> float:
    """The VmRSS of root_pid and every descendant (the encoders), MiB."""
    children: dict[int, list[int]] = {}
    for pid_s in os.listdir("/proc"):
        if not pid_s.isdigit():
            continue
        try:
            with open(f"/proc/{pid_s}/stat") as f:
                stat_line = f.read()
            # comm may hold spaces and parens: the fields are well defined
            # only after the last ')'
            fields = stat_line[stat_line.rindex(")") + 2:].split()
            children.setdefault(int(fields[1]), []).append(int(pid_s))
        except (OSError, ValueError):
            continue
    total_kb = 0
    stack = [root_pid]
    while stack:
        pid = stack.pop()
        stack.extend(children.get(pid, []))
        try:
            with open(f"/proc/{pid}/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        total_kb += int(line.split()[1])
                        break
        except OSError:
            continue
    return total_kb / 1024.0


def device_memory_mb(device) -> tuple:
    """(MiB used on the card, allocator live MiB) of a CUDA device, else
    (None, None)."""
    import torch

    if device.type != "cuda":
        return None, None
    free, total = torch.cuda.mem_get_info(device)
    return (round((total - free) / 2**20, 1),
            round(torch.cuda.memory_allocated(device) / 2**20, 1))


class Sampler(threading.Thread):
    def __init__(self, subclip_dir: str, every_s: float, device,
                 partial_out: Optional[str] = None):
        super().__init__(daemon=True)
        self.subclip_dir = subclip_dir
        self.every_s = every_s
        self.device = device
        self.partial_out = partial_out  # a trail that survives a crash
        self.samples: list[dict] = []
        self._halt = threading.Event()

    def run(self) -> None:
        t0 = time.time()
        while not self._halt.is_set():
            try:
                clips = len([f for f in os.listdir(self.subclip_dir)
                             if f.endswith(".mp4")])
            except OSError:
                clips = 0
            used, live = device_memory_mb(self.device)
            self.samples.append({
                "t": round(time.time() - t0, 1),
                "rss_mb": round(_tree_rss_mb(os.getpid()), 1),
                "device_mb": used, "allocated_mb": live,
                "subclips": clips,
            })
            if self.partial_out and len(self.samples) % 12 == 0:
                try:
                    with open(self.partial_out, "w") as f:
                        json.dump({"partial": True,
                                   "samples": self.samples[-2000:]}, f)
                except OSError:
                    pass
            self._halt.wait(self.every_s)

    def stop(self) -> None:
        self._halt.set()


def _slope_per_hour(ts: List[float], ys: List[float]) -> float:
    """Least-squares slope in units an hour over the given points."""
    import numpy as np

    if len(ts) < 3:
        return 0.0
    t = np.asarray(ts) / 3600.0
    y = np.asarray(ys)
    t = t - t.mean()
    denom = float((t * t).sum())
    return float((t * (y - y.mean())).sum() / denom) if denom else 0.0


def _pct(vals: List[float], q: float) -> float:
    import numpy as np

    return round(float(np.percentile(vals, q)), 2)


def _memory_stats(vals: List[Optional[float]]) -> dict:
    vals = [v for v in vals if v is not None]
    return {"available": bool(vals),
            "start": vals[0] if vals else None,
            "end": vals[-1] if vals else None,
            "peak": max(vals) if vals else None}


def memory_flat(used: List[float]) -> bool:
    """The device-only rule: the card's used memory at the end within
    max(start x 1.05, start + 64 MiB); true where it was not sampled."""
    return not used or used[-1] <= max(used[0] * 1.05, used[0] + 64)


def device_soak(args) -> int:
    """Device-side endurance at full cadence: loop the pipeline's step over
    ``args.device_only`` frames, the SBS kept on the device (a scalar
    checksum read back every few batches bounds the queue)."""
    import numpy as np
    import torch

    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline
    from vr_video_generator_tpu_torch.video.reader import (VideoReader,
                                                           probe_video)

    n_frames = args.device_only
    b = args.batch_size
    _, _, w, h = probe_video(args.video)
    run_cfg = RunConfig(encoder=args.encoder, batch_size=b,
                        depth_stride=args.depth_stride,
                        input_size=args.input_size,
                        chunk_batches=args.chunk_batches,
                        compute_dtype=args.compute_dtype)
    pipe = SbsPipeline.create(run_cfg, h, w, allow_random=True,
                              device=args.device)
    dev = pipe.device
    reader = VideoReader(args.video, 0)
    try:
        feed = []
        for _ in range(8):  # rotating real-content batches
            frames = [reader.read() for _ in range(b)]
            if any(f is None for f in frames):
                raise RuntimeError("source video too short for the feed "
                                   "buffer")
            feed.append(pipe.frames_to_device(np.stack(frames)))
    finally:
        reader.close()
    ck = args.chunk_batches
    if ck > 1:  # k batches a dispatch (step_many)
        feed = [torch.stack([feed[(j + i) % len(feed)] for i in range(ck)])
                for j in range(len(feed))]
        step = pipe.step_many
    else:
        step = pipe.step
    state = pipe.initial_state()

    def sync(out):  # step_many returns a tuple of k batch outputs
        arr = out[-1] if isinstance(out, tuple) else out
        float(arr[0, 0].sum(dtype=torch.float32))

    sbs, state = step(feed[0], state)  # kernel builds, graph capture
    sync(sbs)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    samples: list[dict] = []
    sample_every = max(4, (n_frames // (b * ck)) // 200)
    sync_every = max(1, 4 // ck)
    t0 = time.time()
    done = 0
    batch_i = 0
    step_times: list[float] = []
    tb = time.time()
    while done < n_frames:
        sbs, state = step(feed[batch_i % len(feed)], state)
        batch_i += 1
        done += b * ck
        if batch_i % sync_every == 0:  # bound the queue; amortized sync
            sync(sbs)
            now = time.time()
            step_times.append((now - tb) / (sync_every * ck * b))
            tb = now
        if batch_i % sample_every == 0:
            used, live = device_memory_mb(dev)
            samples.append({
                "t": round(time.time() - t0, 1), "frames": done,
                "rss_mb": round(_tree_rss_mb(os.getpid()), 1),
                "device_mb": used, "allocated_mb": live,
            })
    sync(sbs)
    wall = time.time() - t0

    used = [s["device_mb"] for s in samples if s["device_mb"] is not None]
    ms = [t * 1000 for t in step_times]
    half = len(ms) // 2
    artifact = {
        "mode": "device_only",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "encoder": args.encoder,
        "frames": done, "resolution": f"{w}x{h}",
        "depth_stride": args.depth_stride, "batch_size": b,
        "chunk_batches": ck, "compute_dtype": args.compute_dtype,
        "wall_s": round(wall, 1),
        "fps_device": round(done / wall, 2),
        "step_ms_per_frame": {
            "p10": _pct(ms, 10), "p50": _pct(ms, 50), "p90": _pct(ms, 90),
            "first_half_p50": _pct(ms[:half], 50) if half else 0,
            "second_half_p50": _pct(ms[half:], 50) if half else 0,
        },
        "rss_mb": {
            "start": samples[0]["rss_mb"] if samples else 0,
            "end": samples[-1]["rss_mb"] if samples else 0,
            "slope_mb_per_hour_2nd_half": round(_slope_per_hour(
                [s["t"] for s in samples[len(samples) // 2:]],
                [s["rss_mb"] for s in samples[len(samples) // 2:]]), 1),
        },
        "device_mb": _memory_stats(used),
        "allocated_mb": {
            **_memory_stats([s["allocated_mb"] for s in samples]),
            "max_allocated": (round(torch.cuda.max_memory_allocated(dev)
                                    / 2**20, 1)
                              if dev.type == "cuda" else None)},
        "note": "SBS kept on the device: this mode measures device memory "
                "and step cadence; the CLI mode covers the host I/O tier.",
        "samples": samples[::max(1, len(samples) // 240)],
    }
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    ok = done >= n_frames and memory_flat(used)
    print(json.dumps({k: v for k, v in artifact.items() if k != "samples"},
                     indent=1), flush=True)
    print(f"device soak {'PASS' if ok else 'FAIL'} -> {args.out}", flush=True)
    return 0 if ok else 1


def cli_soak(args) -> int:
    """The instrumented CLI conversion of ``args.video``."""
    from vr_video_generator_tpu_torch.pipeline import resolve_device

    device = resolve_device(args.device)
    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    if shutil.which("ffmpeg") and shutil.which("ffprobe"):
        encoder_note = "host ffmpeg"
    else:
        encoder_note = _install_double(workdir)

    subclip_dir = os.path.join(workdir, "Subclip") + os.sep
    debug_dir = os.path.join(workdir, "Debug") + os.sep
    out_path = os.path.join(workdir, "out.mkv")

    from vr_video_generator_tpu_torch.cli import main as cli_main
    from vr_video_generator_tpu_torch.video.check import check_subclips
    from vr_video_generator_tpu_torch.video.combine import verify_frame_count
    from vr_video_generator_tpu_torch.video.reader import probe_video

    _, n_frames, w, h = probe_video(args.video)
    end_frame = min(args.end_frame, n_frames)
    print(f"soak: {end_frame} frames at {w}x{h}, stride {args.depth_stride}, "
          f"{args.num_workers} encoders via {encoder_note}, "
          f"device={device}", flush=True)

    sampler = Sampler(subclip_dir, args.sample_every, device,
                      partial_out=args.out + ".partial")
    sampler.start()
    t0 = time.time()
    try:
        rc = cli_main([
            "--device", str(device),
            "--VideoDir", args.video, "--OutputDir", out_path,
            "--DebugDir", debug_dir, "--SubClipDir", subclip_dir,
            "--Max_Frame_Count", str(args.max_frame_count),
            "--batch_size", str(args.batch_size),
            "--depth_stride", str(args.depth_stride),
            "--stride_audit_every", "200",
            "--Num_Workers", str(args.num_workers),
            "--end_frame", str(end_frame),
            "--encoder", args.encoder,
            "--input_size", str(args.input_size),
            "--compute_dtype", args.compute_dtype,
            "--allow_random_weights",
        ])
    finally:
        wall_s = time.time() - t0
        sampler.stop()
        sampler.join()

    # The conversion ends at the last subclip's mtime; the combine follows.
    clip_files = sorted(
        (os.path.getmtime(os.path.join(subclip_dir, f)), f)
        for f in os.listdir(subclip_dir) if f.endswith(".mp4"))
    mtimes = [m for m, _ in clip_files]
    convert_s = (mtimes[-1] - t0) if mtimes else 0.0
    cadences = [b - a for a, b in zip(mtimes, mtimes[1:]) if b > a]
    clip_fps = [args.max_frame_count / c for c in cadences] if cadences else []
    half = len(clip_fps) // 2

    conv_samples = [s for s in sampler.samples if s["t"] <= convert_s]
    second_half = [s for s in conv_samples if s["t"] >= convert_s / 2]
    rss_slope = _slope_per_hour([s["t"] for s in second_half],
                                [s["rss_mb"] for s in second_half])

    issues = check_subclips(subclip_dir)
    diff = verify_frame_count(args.video, out_path)

    artifact = {
        "frames": end_frame,
        "resolution": f"{w}x{h}",
        "depth_stride": args.depth_stride,
        "encoder_io": encoder_note,
        "device": str(device),
        "rc": rc,
        "wall_s": round(wall_s, 1),
        "convert_s": round(convert_s, 1),
        "combine_s": round(wall_s - convert_s, 1),
        "fps_e2e_convert": round(end_frame / convert_s, 2) if convert_s else 0,
        "clip_fps": {
            "clips": len(clip_fps),
            "p10": _pct(clip_fps, 10) if clip_fps else 0,
            "p50": _pct(clip_fps, 50) if clip_fps else 0,
            "p90": _pct(clip_fps, 90) if clip_fps else 0,
            "first_half_p50": _pct(clip_fps[:half], 50) if half else 0,
            "second_half_p50": _pct(clip_fps[half:], 50) if half else 0,
        },
        "rss_mb": {
            "start": conv_samples[0]["rss_mb"] if conv_samples else 0,
            "end": conv_samples[-1]["rss_mb"] if conv_samples else 0,
            "peak": max((s["rss_mb"] for s in sampler.samples), default=0),
            "slope_mb_per_hour_2nd_half": round(rss_slope, 1),
        },
        "device_mb": _memory_stats([s["device_mb"] for s in conv_samples]),
        "allocated_mb": _memory_stats([s["allocated_mb"]
                                       for s in conv_samples]),
        "checker_issues": [str(i) for i in issues],
        "frame_count_diff": diff,
        "samples": sampler.samples[::max(1, len(sampler.samples) // 240)],
    }
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    ok = rc == 0 and not issues and diff == 0
    print(json.dumps({k: v for k, v in artifact.items() if k != "samples"},
                     indent=1), flush=True)
    print(f"soak {'PASS' if ok else 'FAIL'} -> {args.out}", flush=True)
    return 0 if ok else 1


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--video", default="/tmp/soak/in.mp4")
    ap.add_argument("--workdir", default="/tmp/soak")
    ap.add_argument("--out", default="SOAK.json")
    ap.add_argument("--device_only", type=int, default=0, metavar="N",
                    help="loop N frames through the device pipeline only "
                         "(no SBS readback): device-memory endurance at "
                         "full cadence")
    ap.add_argument("--depth_stride", type=int, default=2,
                    help="the production-mode stride; 1 = parity mode")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--chunk_batches", type=int, default=1,
                    help="device_only mode: batches a dispatch "
                         "(SbsPipeline.step_many; 1 = a step a batch)")
    ap.add_argument("--encoder", default="vits",
                    help="the depth encoder")
    ap.add_argument("--max_frame_count", type=int, default=250)
    ap.add_argument("--num_workers", type=int, default=6,
                    help="concurrent encoder subprocesses")
    ap.add_argument("--sample_every", type=float, default=5.0)
    ap.add_argument("--end_frame", type=int, default=10**9)
    # knobs of a CPU run of the harness itself
    ap.add_argument("--input_size", type=int, default=518)
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.device_only:
        return device_soak(args)
    return cli_soak(args)


if __name__ == "__main__":
    sys.exit(main())
