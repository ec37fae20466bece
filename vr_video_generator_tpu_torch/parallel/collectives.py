"""The collectives of one model group, in one process.

In the JAX package XLA inserts these from the shardings of
parallel/sharding.py: one all-reduce after each split product, and the
tokens replicated over ``model``. Here a model group is M ranks, each a
device, driven by one process:

  * where the ranks are distinct cards, ``torch.cuda.nccl`` runs the
    collective: one tensor a card, in place, each on its device's current
    stream, the stream every kernel of that rank launches on, so it is
    ordered after the rank's products with no host wait;
  * where ranks share a device (the CPU, or one card named twice), their
    tensors are summed, or copied, on that device: NCCL takes one tensor a
    device. The group is then co-located and nothing moves between
    devices; no card's work goes to the CPU.

A group that mixes both (two ranks on one card, two on another) reduces on
each device first, then across the cards.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch


def device_scope(device: torch.device):
    """Make ``device`` current for the kernels' launches (their C entry
    points launch on the current device); nothing on the CPU."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _by_device(tensors: Sequence[torch.Tensor]
               ) -> Dict[torch.device, List[int]]:
    groups: Dict[torch.device, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.device, []).append(i)
    return groups


def all_reduce_(tensors: Sequence[torch.Tensor]) -> None:
    """Set every tensor of a model group to the sum of all of them, in their
    dtype (as XLA all-reduces a dot's output), in place."""
    groups = _by_device(tensors)
    heads = []
    for dev, idx in groups.items():
        with device_scope(dev):
            head = tensors[idx[0]]
            for i in idx[1:]:
                head.add_(tensors[i])
            heads.append(head)
    if len(heads) > 1:
        if any(h.device.type != "cuda" for h in heads):
            raise ValueError("all_reduce_: a group across devices must be "
                             "all cards, got "
                             f"{[str(h.device) for h in heads]}")
        torch.cuda.nccl.all_reduce(heads)
    for dev, idx in groups.items():
        with device_scope(dev):
            for i in idx[1:]:
                tensors[i].copy_(tensors[idx[0]])


def broadcast_(tensors: Sequence[torch.Tensor]) -> None:
    """Copy the first tensor of a model group into every other, in place."""
    groups = _by_device(tensors)
    src_dev = tensors[0].device
    heads = [tensors[0]] + [tensors[idx[0]] for dev, idx in groups.items()
                            if dev != src_dev]
    if len(heads) > 1:
        if any(h.device.type != "cuda" for h in heads):
            raise ValueError("broadcast_: a group across devices must be all "
                             f"cards, got {[str(h.device) for h in heads]}")
        torch.cuda.nccl.broadcast(heads, root=0)
    for dev, idx in groups.items():
        with device_scope(dev):
            src = tensors[0] if dev == src_dev else tensors[idx[0]]
            for i in idx:
                if tensors[i] is not src:
                    tensors[i].copy_(src)
