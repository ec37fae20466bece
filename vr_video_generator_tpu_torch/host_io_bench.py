"""Host-I/O throughput: numpy against the native tier on the 4K SBS path.

The counterpart of scripts/host_io_bench.py, on the port's ``native`` tier.
It measures the two host-side byte movers that bound a 4K60 SBS output
(2 x 3840 x 2160 x 3 bytes x 60 = 2.99 GB/s):

  * decode staging: a BGR frame into an RGB row of the batch that the
    segment loop uploads (a numpy reversed-slice copy against native
    ``bgr_to_rgb`` straight into the row). On the card the batch is pinned
    host memory, as ``runtime.segment.HostStaging`` allocates its upload
    buffers; with ``--device cpu`` a numpy batch;
  * encoder pipe: raw SBS frames into a subprocess's stdin (``.tobytes()``
    through Python's buffered pipe against native ``write_full`` on the fd).

Each is timed over N_FRAMES frames, REPS times, with the host clock. Run:

    python3 -m vr_video_generator_tpu_torch.host_io_bench [--device cpu]
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

H, W = 2160, 3840            # 4K source; the SBS frame is double width
N_FRAMES = 24
REPS = 4
SINK = "cat > /dev/null"


def gbps(nbytes: int, seconds: float) -> float:
    return nbytes / seconds / 1e9


def cpu_model() -> str:
    """The host CPU's model name from /proc/cpuinfo; where that says
    "unknown" (as a virtual machine's may), its vendor, family and model
    numbers; "unknown" without /proc/cpuinfo."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's block
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        return "unknown"
    name = info.get("model name", "unknown")
    if name != "unknown":
        return name
    return (f"{info.get('vendor_id', 'unknown')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')} "
            f"(no model name)")


def staging_batch(shape, device: torch.device) -> np.ndarray:
    """The (N, H, W, 3) u8 batch decode fills: pinned host memory on the
    card (HostStaging's upload buffers), plain numpy on the CPU."""
    if device.type == "cuda":
        return torch.empty(shape, dtype=torch.uint8, pin_memory=True).numpy()
    return np.empty(shape, np.uint8)


def bench_decode_staging(device: torch.device, h: int = H, w: int = W,
                         n_frames: int = N_FRAMES, reps: int = REPS
                         ) -> Tuple[float, float]:
    """(numpy GB/s, native GB/s) of BGR frames into the batch's rows."""
    from vr_video_generator_tpu_torch import native

    rng = np.random.default_rng(0)
    bgr = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
           for _ in range(n_frames)]
    batch = staging_batch((n_frames, h, w, 3), device)
    total = batch.nbytes * reps

    t0 = time.perf_counter()
    for _ in range(reps):
        for i, f in enumerate(bgr):
            batch[i] = f[:, :, ::-1]
    t_np = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(reps):
        for i, f in enumerate(bgr):
            native.bgr_to_rgb(f, batch[i])
    t_nat = time.perf_counter() - t0
    return gbps(total, t_np), gbps(total, t_nat)


def bench_encoder_pipe(h: int = H, w: int = W, n_frames: int = N_FRAMES,
                       reps: int = REPS, sink: str = SINK
                       ) -> Tuple[float, float]:
    """(python GB/s, native GB/s) of raw (h, 2w, 3) SBS frames into the
    stdin of ``sh -c sink``, one process a measurement."""
    from vr_video_generator_tpu_torch import native

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (n_frames, h, 2 * w, 3), dtype=np.uint8)
    total = frames.nbytes * reps

    def run(write) -> float:
        proc = subprocess.Popen(["sh", "-c", sink], stdin=subprocess.PIPE)
        try:
            t0 = time.perf_counter()
            for _ in range(reps):
                for f in frames:
                    write(proc, f)
            proc.stdin.close()
            rc = proc.wait()
            seconds = time.perf_counter() - t0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if rc != 0:
            raise RuntimeError(f"encoder pipe sink {sink!r} exited {rc}")
        return seconds

    def write_py(proc, f):
        proc.stdin.write(np.ascontiguousarray(f).tobytes())

    def write_native(proc, f):
        if native.write_full(proc.stdin.fileno(), f) < 0:
            raise OSError("native write_full failed")

    return gbps(total, run(write_py)), gbps(total, run(write_native))


def report(device: str = "cuda", h: int = H, w: int = W,
           n_frames: int = N_FRAMES, reps: int = REPS) -> List[str]:
    """The host line and the three lines of the JAX script."""
    from vr_video_generator_tpu_torch import native
    from vr_video_generator_tpu_torch.pipeline import resolve_device

    dev = resolve_device(device)
    if not native.available():
        raise RuntimeError("the native tier (native/framepack.cpp) failed "
                           "to build")
    tag = "4K" if (h, w) == (H, W) else f"{w}x{h}"
    d_np, d_nat = bench_decode_staging(dev, h, w, n_frames, reps)
    e_py, e_nat = bench_encoder_pipe(h, w, n_frames, reps)
    need = 2 * w * h * 3 * 60 / 1e9
    staging = "pinned" if dev.type == "cuda" else "numpy"
    return [f"host: {cpu_model()}; staging batch: {staging}",
            f"decode staging (BGR->RGB batch row, {tag}): "
            f"numpy {d_np:.2f} GB/s -> native {d_nat:.2f} GB/s "
            f"({d_nat / d_np:.2f}x)",
            f"encoder pipe (raw {tag} SBS -> subprocess stdin): "
            f"python {e_py:.2f} GB/s -> native {e_nat:.2f} GB/s "
            f"({e_nat / e_py:.2f}x)",
            f"{tag}{'' if tag == '4K' else '@'}60 SBS requirement: "
            f"{need:.2f} GB/s sustained"]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    for line in report(ap.parse_args(argv).device):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
