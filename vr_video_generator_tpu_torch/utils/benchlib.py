"""Device timing of chained calls.

Mirrors vr_video_generator_tpu/utils/benchlib.py `device_time`. PyTorch runs
eagerly, so there is no compiler to drop unused work or to overlap calls;
what the JAX helper guards against by construction, this one keeps as a
data dependency all the same: every output of every call feeds a device
checksum, and the next call's inputs pass through a select on that checksum
(never true), so the k calls form one chain that ends in a single scalar
read back. On a CUDA device the chain is timed with CUDA events; on the
CPU with ``time.perf_counter``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterator, Tuple

import torch

# Never equal to a checksum of real outputs; the select on it cannot be
# skipped, since the value is known only on the device.
_POISON = 1.2345678e33


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for leaf in tree:
            yield from _tensors(leaf)
    elif isinstance(tree, dict):
        for leaf in tree.values():
            yield from _tensors(leaf)


def checksum(tree: Any) -> torch.Tensor:
    """f32 sum of every tensor in ``tree`` (tensors, tuples, lists, dicts),
    as one device scalar."""
    total = None
    for t in _tensors(tree):
        s = t.sum(dtype=torch.float32)
        total = s if total is None else total + s
    return total if total is not None else torch.zeros(())


def poison(x: Any, cs: torch.Tensor) -> Any:
    """``x`` unchanged, through a select on ``cs`` that is never true: the
    next call's inputs depend on this call's checksum."""
    if not isinstance(x, torch.Tensor):
        return x
    if x.dtype == torch.bool:
        flip = ~x
    else:
        flip = x + 1 if x.dtype.is_floating_point else x ^ 1
    return torch.where(cs == _POISON, flip, x)


def device_time(fn: Callable, *args: Any, k: int = 8,
                reps: int = 3) -> Tuple[float, float]:
    """Best seconds per call of ``fn(*args)`` over ``reps`` chains of ``k``
    calls, after one untimed call (kernel builds, caches, graph capture).
    Returns (seconds_per_call, best_total_seconds_for_k)."""
    device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                  torch.device("cpu"))
    cuda = device.type == "cuda"

    def chain() -> torch.Tensor:
        cs = torch.zeros((), device=device)
        inputs = args
        for _ in range(k):
            cs = cs + checksum(fn(*inputs))
            inputs = tuple(poison(a, cs) for a in args)
        return cs

    float(checksum(fn(*args)))  # warm-up
    best = float("inf")
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            cs = chain()
            end.record()
            float(cs)  # the one scalar read back
            seconds = start.elapsed_time(end) * 1e-3
        else:
            t0 = time.perf_counter()
            float(chain())
            seconds = time.perf_counter() - t0
        best = min(best, seconds)
    return best / k, best
