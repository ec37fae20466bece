"""Hand-written Hopper kernels: build, binding and launch counting.

Every kernel wrapper in ``ops/`` takes its plain PyTorch version only for
tensors on the CPU; for CUDA tensors it launches its kernel or raises. Each
wrapper owns a :class:`LaunchCounter`, incremented where the kernel is
launched and nowhere else, so a run can show which kernels it went through.
"""

from __future__ import annotations

from typing import Dict

import torch


class LaunchCounter:
    """Number of launches of one kernel."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0


COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    return COUNTERS.setdefault(name, LaunchCounter(name))


def launch_counts() -> Dict[str, int]:
    return {name: c.count for name, c in COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.count = 0


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device, False when every tensor
    is on the CPU; raises for any other mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"kernel inputs on mixed or unsupported devices: "
                     f"{sorted({str(t.device) for t in tensors})}")


def stream_handle(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream
