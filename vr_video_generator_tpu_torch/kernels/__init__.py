"""Hand-written Hopper kernels: build, binding and launch counting.

Every kernel wrapper in ``ops/`` takes its plain PyTorch version only for
tensors on the CPU; for CUDA tensors it launches its kernel or raises. Each
wrapper owns a :class:`LaunchCounter`, incremented where the kernel is
launched and nowhere else, so a run can show which kernels it went through.
A CUDA graph launches without the wrappers: ``pipeline.StepGraph`` takes
back what its capture counted and adds it at each replay.
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
    first = tensors[0]
    if first.is_cuda:
        index = first.get_device()
        if all(t.is_cuda and t.get_device() == index for t in tensors):
            return True
    elif all(t.device.type == "cpu" for t in tensors):
        return False
    raise ValueError(f"kernel inputs on mixed or unsupported devices: "
                     f"{sorted({str(t.device) for t in tensors})}")


def stream_handle(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an integer handle. The raw
    query (the one torch's own generated kernels use) skips building a
    ``torch.cuda.Stream`` object: a few microseconds of host time a launch,
    which a kernel of tens of microseconds feels."""
    return torch._C._cuda_getCurrentRawStream(device.index)
