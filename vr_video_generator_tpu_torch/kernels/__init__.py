"""Hand-written Hopper kernels: build, binding and launch counting.

Every kernel wrapper in ``ops/`` takes its plain PyTorch version only for
tensors on the CPU; for CUDA tensors it launches its kernel or raises. Each
wrapper owns a :class:`LaunchCounter`, incremented where the kernel is
launched and nowhere else, so a run can show which kernels it went through.
A CUDA graph launches without the wrappers: ``pipeline.StepGraph`` takes
back what its capture counted and adds it at each replay.

A process started with ``VRVG_LAUNCH_COUNTS_DIR`` set writes its counts,
when it exits, to ``launch_counts_<pid>.json`` in that directory (its argv
and every non-zero count), so a caller can count the launches of an entry
point it runs as a subprocess (the UI's runs, the runbook's parity step).
"""

from __future__ import annotations

import atexit
import json
import os
import sys
from typing import Dict

import torch

COUNTS_DIR_ENV = "VRVG_LAUNCH_COUNTS_DIR"


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


def write_launch_counts(directory: str) -> None:
    """Write this process's argv and non-zero launch counts to
    ``launch_counts_<pid>.json`` in ``directory``."""
    path = os.path.join(directory, f"launch_counts_{os.getpid()}.json")
    with open(path, "w") as f:
        json.dump({"argv": sys.argv,
                   "counts": {k: v for k, v in launch_counts().items() if v}},
                  f)


if os.environ.get(COUNTS_DIR_ENV):
    atexit.register(write_launch_counts, os.environ[COUNTS_DIR_ENV])


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
