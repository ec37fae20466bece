"""Profiling hooks: per-stage wall timing to CSV, and torch.profiler traces.

Mirrors vr_video_generator_tpu/utils/profiling.py: ``StageTimer`` collects
wall-clock per named stage and dumps it in the reference's
function/line/hits/total-µs/per-hit CSV schema; ``trace`` runs a block
under ``torch.profiler`` (the JAX package's ``jax.profiler.trace``) and
writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import csv
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

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


@contextlib.contextmanager
def trace(log_dir: Optional[str], name: Optional[str] = None
          ) -> Iterator[Optional[torch.profiler.profile]]:
    """Run the block under ``torch.profiler`` (CPU activity, and CUDA
    activity where a GPU is available) and write its Chrome trace to
    ``log_dir/name`` (default ``trace_<time>_<pid>.json``) when the block
    ends without an error. Yields the profiler; a no-op yielding None for a
    falsy ``log_dir``."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    name = name or f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))
