"""Multi-host bootstrap: the process group and per-process slot ownership.

Mirrors vr_video_generator_tpu/parallel/multihost.py. On several hosts (or
several processes of one host) each process owns the ``data`` slots of the
global mesh whose devices it holds: the video is partitioned once globally
(runtime/sharded_runner.partition_segments), every process decodes, steps
and encodes only its own slots, and frames never cross processes. A slot's
model group lies inside one process, so no collective crosses processes
either: only the rendezvous, the device census of :func:`make_global_mesh`
and a final barrier do, and gloo carries them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from vr_video_generator_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the process group when running multi-host (gloo, rendezvous at
    ``tcp://<coordinator_address>``); a no-op on a single host with no
    coordinator configured, as the JAX package's. torch.distributed finds
    no cluster by itself, so the address, the process count and this
    process's id are all required."""
    if coordinator_address is None and num_processes in (None, 1):
        return
    if not coordinator_address or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a multi-host run needs --coordinator_address host:port, "
            "--num_processes and --process_id, got "
            f"{coordinator_address!r}, {num_processes}, {process_id}")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    """Wait for every process of the group; nothing in one process."""
    if dist.is_initialized():
        dist.barrier()


def local_devices(device: str = "cuda") -> List[torch.device]:
    """This process's devices of type ``device``: every visible card; on the
    CPU one."""
    if device == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device)]


def make_global_mesh(shape: Optional[Tuple[int, int]] = None,
                     local: Optional[Sequence] = None,
                     device: str = "cuda") -> Mesh:
    """A mesh over every process's devices: each process's ``local`` list
    (default :func:`local_devices`; on the CPU an explicit list such as
    ``["cpu"] * 4``, the counterpart of the JAX package's virtual devices)
    gathered in process order, each device marked with its owner."""
    local = [str(torch.device(d)) for d in
             (local if local is not None else local_devices(device))]
    gathered: List[List[str]] = [local]
    if dist.is_initialized():
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, local)
    devices = [d for part in gathered for d in part]
    owners = [p for p, part in enumerate(gathered) for _ in part]
    return make_mesh(shape, devices=devices, processes=owners)


def local_data_slots(mesh: Mesh) -> List[int]:
    """Indices along ``data`` whose first device this process owns: the
    segment slices this process decodes, steps and encodes."""
    me = process_index()
    return [i for i, row in enumerate(mesh.processes) if row[0] == me]
