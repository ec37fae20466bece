"""The SBS pipeline over the data axis of a mesh (PyTorch).

Mirrors vr_video_generator_tpu/parallel/sharded.py `ShardedSbsPipeline` at
``model`` = 1. In the JAX package the flattened (n_data * B) frame batch
is sharded over ``data``, every weight is replicated there, the temporal
scan runs per slot under ``shard_map`` and no collective runs in the step.
So the port carries that structure over as one ``SbsPipeline`` replica per
data slot, in one process:

  * each replica sits on its slot's device with its own copy of the
    weights (copied, never shared, also where two slots name one device);
  * slot i's step is that replica's step on frames [i B, (i + 1) B) of the
    batch, with its own temporal state, depth stride and emit; so a slot's
    state and SBS are, by construction, what an ``SbsPipeline`` gives on the
    slot's frames at the same batch (the depth at another batch is not
    bit-equal on the card: compare at equal batch);
  * a step issues every slot's work, each under its own device, before the
    host reads anything back, and no slot's step waits on another's. On the
    card a full batch replays the slot's captured single-step CUDA graph
    (``SbsPipeline.step_many`` with k = 1, :class:`pipeline.StepGraph`):
    bit for bit an eager step, for a fraction of its host time, which
    bounds a dispatch round at D slots; a short batch (``n_valid`` below
    B) steps eagerly.

The states are a per-slot list of ``TemporalState``; slot i compares field
by field with the JAX package's ``states[i]``. A step returns the per-slot
SBS tensors, each on its slot's device.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vr_video_generator_tpu_torch import not_ported
from vr_video_generator_tpu_torch.ops.temporal import (TemporalState,
                                                        stride_audit_stats)
from vr_video_generator_tpu_torch.parallel.mesh import Mesh
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


def device_scope(device: torch.device):
    """Make ``device`` current for the kernels' launches (their C entry
    points launch on the current device); nothing on the CPU."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


class ShardedSbsPipeline:
    """Pipeline over the data axis of a mesh for a fixed video geometry.

    ``step`` consumes (n_data * B, H, W, 3) uint8 frames, n_data contiguous
    temporal slices concatenated (or a list of the n_data slices), and the
    per-slot states."""

    def __init__(self, model, height: int, width: int, mesh: Mesh,
                 run_cfg: Optional[RunConfig] = None):
        self.run_cfg = run_cfg or RunConfig(encoder=model.cfg.encoder)
        check_supported(self.run_cfg)
        if mesh.shape["model"] > 1:
            not_ported(f"a mesh with model = {mesh.shape['model']}",
                       "sharded runtime, model axis and multi-host")
        self.model = model
        self.mesh = mesh
        self.n_data = mesh.shape["data"]
        self.devices = mesh.data_devices
        self.height, self.width = height, width
        self.depth_stride = self.run_cfg.depth_stride
        self.replicas: List[SbsPipeline] = []
        for dev in self.devices:
            with device_scope(dev):
                replica = copy.deepcopy(model).to(dev)
                self.replicas.append(SbsPipeline(replica, height, width,
                                                 run_cfg=self.run_cfg))
        self.spec = self.replicas[0].spec
        self.sbs_emit = self.replicas[0].sbs_emit
        self.preprocess_impl = self.replicas[0].preprocess_impl

    @property
    def local_slots(self) -> List[int]:
        """``data`` slots this process owns: all of them (one process)."""
        return list(range(self.n_data))

    def initial_state(self) -> List[TemporalState]:
        return batched_initial_state(self.n_data, self.height, self.width,
                                     self.depth_stride, self.devices)

    def _split(self, frames: Frames) -> list:
        """The n_data per-slot batches of ``frames``."""
        if isinstance(frames, (np.ndarray, torch.Tensor)):
            n = frames.shape[0]
            if n % self.n_data:
                raise ValueError(f"{n} frames do not split into "
                                 f"{self.n_data} data slots")
            b = n // self.n_data
            return [frames[i * b:(i + 1) * b] for i in range(self.n_data)]
        if len(frames) != self.n_data:
            raise ValueError(f"{len(frames)} slot batches for "
                             f"{self.n_data} data slots")
        return list(frames)

    def step(self, frames_u8: Frames, states: Sequence[TemporalState],
             n_valid=None) -> Tuple[List[torch.Tensor], List[TemporalState]]:
        """One batch of every slot -> (per-slot SBS, per-slot states').
        ``n_valid``: (n_data,) real (non-padding) frames per slot this step;
        only those count toward the overflow diagnostic. None means every
        frame is real."""
        parts = self._split(frames_u8)
        b = parts[0].shape[0]
        sbs, out_states = [], []
        for i, (replica, part, state) in enumerate(zip(self.replicas, parts,
                                                       states)):
            nv = None if n_valid is None else int(n_valid[i])
            with device_scope(replica.device):
                if replica.device.type == "cuda" and nv in (None, b):
                    outs, state = replica.step_many(part[None], state)
                    out = outs[0]
                else:
                    out, state = replica.step(part, state, n_valid=nv)
            sbs.append(out)
            out_states.append(state)
        return sbs, out_states

    def step_local(self, local_frames_u8: Frames,
                   states: Sequence[TemporalState], n_valid_local=None):
        """The multi-host step of the JAX package: this process's slots'
        frames. One process owns every slot, so it is :meth:`step`."""
        return self.step(local_frames_u8, states, n_valid_local)

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

    @staticmethod
    def _per_slot_audit(stats) -> Dict[int, Tuple[float, float]]:
        """{data slot -> (rms, max)}, read back after every slot's audit
        has been issued."""
        return {i: (float(rms), float(mx)) for i, (rms, mx) in enumerate(stats)}

    def stride_audit(self, frames_u8: Frames,
                     states: Sequence[TemporalState]
                     ) -> Dict[int, Tuple[float, float]]:
        """The sampled depth-stride fidelity check per slot (the same math
        as ``SbsPipeline.stride_audit``): depth on every frame of each
        slot's batch against what its stride path would interpolate.
        Read-only; call before ``step`` on the same inputs. Returns {slot:
        (rms, max)} in scaled depth units."""
        return self._per_slot_audit(self._audit(frames_u8, states))

    def stride_audit_local(self, local_frames_u8: Frames,
                           states: Sequence[TemporalState]):
        """The multi-host audit of the JAX package: :meth:`stride_audit`."""
        return self.stride_audit(local_frames_u8, states)
