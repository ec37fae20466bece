"""Profiling hooks: per-stage wall timing to CSV, and torch.profiler traces.

Mirrors vr_video_generator_tpu/utils/profiling.py: ``StageTimer`` collects
wall-clock per named stage and dumps it in the reference's
function/line/hits/total-µs/per-hit CSV schema; ``trace`` runs a block
under ``torch.profiler`` (the JAX package's ``jax.profiler.trace``) and
writes a Chrome trace.

On the card, a ``torch.profiler`` session that starts a while after an
earlier one in the same process records fewer of the device's kernels, or
none (ROADMAP fault 5: 3, 1 and 0 of 3 kernels at 0, 40 and 75 s after the
first on an H100 with torch 2.11; a fresh profiler state in the process, a
session right before, a longer first session and padding the session with
idle time all recorded none). So ``trace`` refuses to write a trace whose
device events are fewer than the kernels its block launched
(:func:`lost_device_events`), and the port's benches take each profile
after their first in a fresh process (:func:`in_fresh_process`), whose
first session records them all.
"""

from __future__ import annotations

import contextlib
import csv
import multiprocessing
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, Iterator, Optional, TypeVar

import torch


class StageTimer:
    """Wall-clock per named stage, dumped in the JAX package's CSV schema."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.hits: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.hits[name] += 1

    def dump_csv(self, filename: str) -> None:
        file_exists = os.path.exists(filename)
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        with open(filename, "a", newline="", encoding="utf-8") as f:
            writer = csv.writer(f)
            if not file_exists:
                writer.writerow(["Function", "Line #", "Line Content",
                                 "Hits", "Total Time (µs)", "Per Hit (µs)"])
            for name in sorted(self.totals):
                total_us = self.totals[name] * 1e6
                hits = self.hits[name]
                writer.writerow([name, 0, "", hits, f"{total_us:.0f}",
                                 f"{total_us / max(hits, 1):.2f}"])


# Host calls that launch one kernel each, and those that put any work on
# the device (a graph launch, a copy, a fill).
KERNEL_LAUNCHES = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC",
                             "cuLaunchKernel", "cuLaunchKernelEx",
                             "cudaLaunchCooperativeKernel"))
DEVICE_WORK = KERNEL_LAUNCHES | {"cudaGraphLaunch", "cudaMemcpyAsync",
                                 "cudaMemsetAsync", "cudaMemcpy",
                                 "cudaMemset"}


def lost_device_events(events: Iterable) -> Optional[str]:
    """Why a profile's events (``prof.events()``: each with a ``name`` and a
    ``device_type``) lack device activity that its host side launched, or
    None: device work was launched and no device event was recorded, or
    fewer kernels than the host launched one by one."""
    launched = work = device = kernels = 0
    for e in events:
        if e.device_type.name == "CUDA":
            device += 1
            kernels += not e.name.startswith(("Memcpy", "Memset"))
        elif e.name in DEVICE_WORK:
            work += 1
            launched += e.name in KERNEL_LAUNCHES
    if (work and not device) or kernels < launched:
        return (f"the profile holds {kernels} device kernels and {device} "
                f"device events for {launched} kernel launches and {work} "
                f"calls that put work on the device: torch.profiler stopped "
                f"recording the card (a session a while after another one "
                f"in the same process, ROADMAP fault 5); take the profile "
                f"in a fresh process (utils.profiling.in_fresh_process)")
    return None


@contextlib.contextmanager
def trace(log_dir: Optional[str], name: Optional[str] = None
          ) -> Iterator[Optional[torch.profiler.profile]]:
    """Run the block under ``torch.profiler`` (CPU activity, and CUDA
    activity where a GPU is available) and write its Chrome trace to
    ``log_dir/name`` (default ``trace_<time>_<pid>.json``) when the block
    ends without an error. With CUDA activity the device is synchronized
    before the session ends, and a session that lost the device's events
    (:func:`lost_device_events`) raises RuntimeError and writes nothing.
    Yields the profiler; a no-op yielding None for a falsy ``log_dir``."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    if cuda:
        lost = lost_device_events(prof.events())
        if lost:
            raise RuntimeError(f"trace: {lost}")
    os.makedirs(log_dir, exist_ok=True)
    name = name or f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


T = TypeVar("T")


def in_fresh_process(fn: Callable[..., T], *args) -> T:
    """``fn(*args)`` in a child process started with ``spawn`` (a process
    whose profiler has never run: its first session records the device's
    events), and its result. ``fn`` is a module-level function, its
    arguments and result picklable; the child's error is raised here."""
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(fn, args)
