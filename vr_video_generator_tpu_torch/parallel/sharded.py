"""The SBS pipeline over a (data, model) mesh (PyTorch).

Mirrors vr_video_generator_tpu/parallel/sharded.py `ShardedSbsPipeline`. In
the JAX package the flattened (n_data * B) frame batch is sharded over
``data``, the ViT's attention and MLP weights over ``model``
(parallel/sharding.py), the temporal scan runs per slot under ``shard_map``
and no collective crosses slots. So the port carries that structure over as
one ``SbsPipeline`` replica per data slot this process owns:

  * at ``model`` = 1 each replica sits on its slot's device with its own
    copy of the weights (copied, never shared, also where two slots name
    one device); at ``model`` = M > 1 its model is the slot's
    :class:`models.depth_anything_v2.ModelGroup`, rank r holding its shards
    on the slot's r-th device (models/factory.build_group), and the frames,
    the temporal state, the warp and the stride audit live on the group's
    first device;
  * slot i's step is that replica's step on frames [i B, (i + 1) B) of the
    batch, with its own temporal state, depth stride and emit; so a slot's
    state and SBS are what an ``SbsPipeline`` gives on the slot's frames at
    the same batch (the depth at another batch is not bit-equal on the
    card: compare at equal batch);
  * a step issues every slot's work, each under its own device, before the
    host reads anything back, and no slot's step waits on another's. At
    ``model`` = 1 on the card a full batch replays the slot's captured
    single-step CUDA graph (``SbsPipeline.step_many`` with k = 1,
    :class:`pipeline.StepGraph`): bit for bit an eager step, for a fraction
    of its host time; a short batch (``n_valid`` below B) steps eagerly. A
    model group's step runs eagerly.

On several processes (parallel/multihost.py) each process owns the slots
whose devices it holds and builds replicas for those only: ``step_local``
and ``stride_audit_local`` take this process's slots' frames, in ascending
slot order, as the JAX package's do. The states are a list of
``TemporalState``, one per owned slot in that order; slot i compares field by
field with the JAX package's ``states[i]``. A step returns the per-slot SBS
tensors, each on its slot's first device.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vr_video_generator_tpu_torch.models.factory import build_group
from vr_video_generator_tpu_torch.ops.temporal import (TemporalState,
                                                        stride_audit_stats)
from vr_video_generator_tpu_torch.parallel.collectives import device_scope
from vr_video_generator_tpu_torch.parallel.mesh import Mesh
from vr_video_generator_tpu_torch.parallel.multihost import (local_data_slots,
                                                             process_count)
from vr_video_generator_tpu_torch.parallel.sharding import check_model_axis
from vr_video_generator_tpu_torch.pipeline import SbsPipeline, check_supported
from vr_video_generator_tpu_torch.utils.config import RunConfig

Frames = Union[np.ndarray, torch.Tensor, Sequence[Union[np.ndarray,
                                                        torch.Tensor]]]


def batched_initial_state(n_data: int, height: int, width: int,
                          depth_stride: int = 1,
                          devices: Optional[Sequence[torch.device]] = None
                          ) -> List[TemporalState]:
    """The cold state of each of ``n_data`` slots, slot i on ``devices[i]``
    (the CPU without ``devices``)."""
    devices = devices or [torch.device("cpu")] * n_data
    return [TemporalState.initial(height, width, dev, depth_stride)
            for dev in devices[:n_data]]


class ShardedSbsPipeline:
    """Pipeline over a (data, model) mesh for a fixed video geometry.

    ``step`` consumes (n_data * B, H, W, 3) uint8 frames, n_data contiguous
    temporal slices concatenated (or a list of the n_data slices), and the
    per-slot states."""

    def __init__(self, model, height: int, width: int, mesh: Mesh,
                 run_cfg: Optional[RunConfig] = None):
        self.run_cfg = run_cfg or RunConfig(encoder=model.cfg.encoder)
        check_supported(self.run_cfg)
        self.model = model
        self.mesh = mesh
        self.n_data, self.n_model = mesh.shape["data"], mesh.shape["model"]
        check_model_axis(model.cfg, self.n_model)
        self.height, self.width = height, width
        self.depth_stride = self.run_cfg.depth_stride
        self.local_slots = local_data_slots(mesh)
        self._check_slot_ownership()
        self.devices = [mesh.devices[i][0] for i in self.local_slots]
        self.replicas: List[SbsPipeline] = []
        for i in self.local_slots:
            group = mesh.devices[i]
            with device_scope(group[0]):
                replica = (copy.deepcopy(model).to(group[0])
                           if self.n_model == 1 else build_group(model, group))
                self.replicas.append(SbsPipeline(replica, height, width,
                                                 run_cfg=self.run_cfg))
        self.spec = self.replicas[0].spec
        self.sbs_emit = self.replicas[0].sbs_emit
        self.preprocess_impl = self.replicas[0].preprocess_impl

    def _check_slot_ownership(self) -> None:
        """Feeding is process-local by design (frames never cross processes:
        ``step_local`` takes only this process's slots), which needs every
        process to own n_data / process_count whole slots (the JAX
        package's check), and, in the port, every slot's model group inside
        one process: its collectives run in one process."""
        for i, owners in enumerate(self.mesh.processes):
            if len(set(owners)) > 1:
                raise ValueError(
                    f"data slot {i}'s model group spans processes {owners}: "
                    "a slot's model group must lie inside one process")
        n_proc = process_count()
        owned = len(self.local_slots)
        if owned == 0 or self.n_data % n_proc \
                or owned != self.n_data // n_proc:
            raise ValueError(
                f"mesh data axis ({self.n_data}) must split into whole "
                f"per-process slot groups across {n_proc} processes (this "
                f"process owns {owned}); pick a mesh whose data extent is "
                "a multiple of the process count")

    @property
    def multi_host(self) -> bool:
        return len(self.local_slots) < self.n_data

    def initial_state(self) -> List[TemporalState]:
        """The cold state of every owned slot, on its first device."""
        return batched_initial_state(len(self.devices), self.height,
                                     self.width, self.depth_stride,
                                     self.devices)

    def _split(self, frames: Frames) -> list:
        """The per-slot batches of ``frames`` (this process's slots)."""
        n_slots = len(self.local_slots)
        if isinstance(frames, (np.ndarray, torch.Tensor)):
            n = frames.shape[0]
            if n % n_slots:
                raise ValueError(f"{n} frames do not split into "
                                 f"{n_slots} data slots")
            b = n // n_slots
            return [frames[i * b:(i + 1) * b] for i in range(n_slots)]
        if len(frames) != n_slots:
            raise ValueError(f"{len(frames)} slot batches for "
                             f"{n_slots} data slots")
        return list(frames)

    def _require_every_slot(self, what: str) -> None:
        if self.multi_host:
            raise ValueError(f"{what} takes every slot's frames; this process "
                             f"owns slots {self.local_slots} of "
                             f"{self.n_data}: use {what}_local")

    def step(self, frames_u8: Frames, states: Sequence[TemporalState],
             n_valid=None) -> Tuple[List[torch.Tensor], List[TemporalState]]:
        """One batch of every slot -> (per-slot SBS, per-slot states').
        ``n_valid``: (n_data,) real (non-padding) frames per slot this step;
        only those count toward the overflow diagnostic. None means every
        frame is real."""
        self._require_every_slot("step")
        return self.step_local(frames_u8, states, n_valid)

    def step_local(self, local_frames_u8: Frames,
                   states: Sequence[TemporalState], n_valid_local=None):
        """The multi-host step: ``local_frames_u8`` holds only this
        process's slots, in ascending slot order, as do ``states`` and
        ``n_valid_local``; one process owns every slot, and then it is
        :meth:`step`."""
        parts = self._split(local_frames_u8)
        b = parts[0].shape[0]
        graphs = self.n_model == 1
        sbs, out_states = [], []
        for i, (replica, part, state) in enumerate(zip(self.replicas, parts,
                                                       states)):
            nv = None if n_valid_local is None else int(n_valid_local[i])
            with device_scope(replica.device):
                if graphs and replica.device.type == "cuda" \
                        and nv in (None, b):
                    outs, state = replica.step_many(part[None], state)
                    out = outs[0]
                else:
                    out, state = replica.step(part, state, n_valid=nv)
            sbs.append(out)
            out_states.append(state)
        return sbs, out_states

    @torch.inference_mode()
    def _audit(self, frames_u8: Frames, states: Sequence[TemporalState]):
        if self.depth_stride < 2:
            raise ValueError("stride_audit requires depth_stride > 1")
        stats = []
        for replica, part, state in zip(self.replicas, self._split(frames_u8),
                                        states):
            with device_scope(replica.device):
                true = replica.depth_only(part)
                stats.append(stride_audit_stats(true, state,
                                                self.depth_stride))
        return stats

    def _per_slot_audit(self, stats) -> Dict[int, Tuple[float, float]]:
        """{global data slot -> (rms, max)} for this process's slots, read
        back after every slot's audit has been issued."""
        return {slot: (float(rms), float(mx))
                for slot, (rms, mx) in zip(self.local_slots, stats)}

    def stride_audit(self, frames_u8: Frames,
                     states: Sequence[TemporalState]
                     ) -> Dict[int, Tuple[float, float]]:
        """The sampled depth-stride fidelity check per slot (the same math
        as ``SbsPipeline.stride_audit``): depth on every frame of each
        slot's batch against what its stride path would interpolate.
        Read-only; call before ``step`` on the same inputs. Returns {slot:
        (rms, max)} in scaled depth units."""
        self._require_every_slot("stride_audit")
        return self.stride_audit_local(frames_u8, states)

    def stride_audit_local(self, local_frames_u8: Frames,
                           states: Sequence[TemporalState]):
        """The multi-host audit: this process's slots' frames (the layout of
        :meth:`step_local`) -> this process's {slot: (rms, max)}."""
        return self._per_slot_audit(self._audit(local_frames_u8, states))
