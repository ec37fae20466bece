"""The device mesh of a sharded run (PyTorch).

Mirrors vr_video_generator_tpu/parallel/mesh.py `make_mesh`. Its axes:

  * ``data``: frame-segment parallelism. Each slot owns one contiguous
    temporal slice of the video with its own smoothing state: the
    reference's N segment-worker processes, each on a device of its own.
  * ``model``: tensor parallelism inside the depth net: a row of the grid
    is one data slot's model group, whose ranks split the ViT's heads and
    MLP hidden (parallel/sharding.py; the collectives of
    parallel/collectives.py where XLA inserts them in the JAX package).

A mesh here is an (n_data, n_model) grid of ``torch.device``s, each as its
own process names it, and the same grid of the processes that own them
(all 0 in one process; parallel/multihost.make_global_mesh fills it).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


class Mesh:
    """An (n_data, n_model) grid of devices, with the JAX Mesh's ``shape``
    ({"data": n_data, "model": n_model}) and ``devices`` (rows of the grid),
    and ``processes``: the rank of the process that owns each device."""

    def __init__(self, devices: Sequence[Sequence[torch.device]],
                 processes: Optional[Sequence[Sequence[int]]] = None):
        self.devices: List[List[torch.device]] = [list(r) for r in devices]
        self.shape = {"data": len(self.devices),
                      "model": len(self.devices[0])}
        self.processes: List[List[int]] = (
            [list(r) for r in processes] if processes is not None
            else [[0] * len(r) for r in self.devices])

    @property
    def data_devices(self) -> List[torch.device]:
        """The device of each data slot (its first along ``model``)."""
        return [row[0] for row in self.devices]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape['data']}x{self.shape['model']}: "
                f"{[[str(d) for d in r] for r in self.devices]})")


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None,
              device: str = "cuda",
              processes: Optional[Sequence[int]] = None) -> Mesh:
    """A (data, model) mesh. Without ``devices`` it takes every device of
    type ``device``: on CUDA all of ``torch.cuda.device_count()`` cards, and
    n_data * n_model must equal that count, as the JAX package requires of
    ``jax.devices()``; on the CPU there is one. An explicit ``devices``
    list may name one device more than once (D slots on ``cpu``, two slots
    or a model group on ``cuda:0``). ``shape=None`` puts every device on
    ``data``. ``processes``: each device's owner, in the order of
    ``devices`` (parallel/multihost.make_global_mesh)."""
    if devices is None:
        if device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("make_mesh: no CUDA GPU is available "
                                   "(torch.cuda.is_available() is False); "
                                   "pass device='cpu' or an explicit "
                                   "devices list")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        elif device == "cpu":
            devices = [torch.device("cpu")]
        else:
            raise ValueError(f"unsupported device {device!r}")
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devices), 1)
    if len(shape) != 2:
        raise ValueError(f"mesh shape must be (data, model), got {shape}")
    n_data, n_model = (int(v) for v in shape)
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh shape {shape} must be positive")
    if n_data * n_model != len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} != {len(devices)} "
                         f"devices")

    def rows(flat):
        return [flat[i * n_model:(i + 1) * n_model] for i in range(n_data)]

    return Mesh(rows(devices),
                None if processes is None else rows(list(processes)))
