"""The per-batch SBS pipeline on one device (PyTorch).

Mirrors vr_video_generator_tpu/pipeline.py at depth_stride 1:

    uint8 RGB frames (B, H, W, 3)
      -> exact preprocess (/255, INTER_AREA resize, ImageNet normalize)
      -> DINOv2 + DPT depth forward (compute dtype; LayerNorm and attention
         kernels)
      -> bicubic upsample to the source size x encoder scaler
      -> temporal EWMA (depth dampening + offset-range smoothing)
      -> plane/shift tables, forward-warp compositor kernel, hole-fill +
         SBS kernel
      -> uint8 (B, H, 2W, 3)

The temporal state crosses batch boundaries, so batching is invisible.
PyTorch runs eagerly: ``step`` enqueues the batch's work on the device's
current stream and returns without waiting for it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vr_video_generator_tpu.utils.config import RunConfig
from vr_video_generator_tpu_torch import not_ported
from vr_video_generator_tpu_torch.models.depth_anything_v2 import (
    DepthAnythingV2, infer_depth)
from vr_video_generator_tpu_torch.models.factory import load_model
from vr_video_generator_tpu_torch.ops.temporal import (TemporalState,
                                                        temporal_scan)
from vr_video_generator_tpu_torch.ops.warp import WarpSpec


def resolve_device(device: torch.device | str) -> torch.device:
    """The torch device to run on; a CUDA device without a usable GPU
    raises rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but no CUDA GPU "
                           "is available (torch.cuda.is_available() is "
                           "False); pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def check_supported(run_cfg: RunConfig) -> None:
    """Raise for the RunConfig options this package does not have yet."""
    if run_cfg.depth_stride < 1:
        raise ValueError(f"depth_stride must be >= 1, got {run_cfg.depth_stride}")
    if run_cfg.chunk_batches < 1:
        raise ValueError(f"chunk_batches must be >= 1, "
                         f"got {run_cfg.chunk_batches}")
    if run_cfg.depth_stride > 1:
        not_ported(f"depth_stride={run_cfg.depth_stride}",
                   "depth_stride and the stride audit")
    if run_cfg.chunk_batches > 1:
        not_ported(f"chunk_batches={run_cfg.chunk_batches}", "step_many")
    if run_cfg.sbs_output == "packed":
        not_ported("sbs_output='packed'", "packed SBS output")
    if run_cfg.preprocess == "folded":
        not_ported("preprocess='folded'", "folded preprocess")
    if run_cfg.mlp_fused == "fused":
        not_ported("mlp_fused='fused'", "fused ViT half-block kernels")
    if run_cfg.tail == "fused":
        not_ported("tail='fused'", "fused DPT tail kernels")
    if run_cfg.gelu != "exact":
        not_ported(f"gelu={run_cfg.gelu!r}", "UI impl switches")


class SbsPipeline:
    """Single-device pipeline for a fixed (height, width) video geometry."""

    def __init__(self, model: DepthAnythingV2, height: int, width: int,
                 run_cfg: Optional[RunConfig] = None):
        self.run_cfg = run_cfg or RunConfig(encoder=model.cfg.encoder)
        check_supported(self.run_cfg)
        self.model = model
        self.device = next(model.parameters()).device
        self.height, self.width = height, width
        self.spec = WarpSpec.create(height, width, self.run_cfg.stereo())

    @classmethod
    def create(cls, run_cfg: RunConfig, height: int, width: int,
               allow_random: bool = False, dtype: Optional[torch.dtype] = None,
               device: torch.device | str = "cuda",
               seed: int = 0) -> "SbsPipeline":
        check_supported(run_cfg)
        device = resolve_device(device)
        if dtype is None:
            dtype = (torch.bfloat16 if run_cfg.compute_dtype == "bfloat16"
                     else torch.float32)
        model = load_model(run_cfg.encoder, run_cfg.encoder_path, dtype=dtype,
                           device=device, allow_random=allow_random,
                           seed=seed, cfg=run_cfg.model())
        return cls(model, height, width, run_cfg=run_cfg)

    def initial_state(self) -> TemporalState:
        return TemporalState.initial(self.height, self.width, self.device)

    def frames_to_device(self, frames_u8) -> torch.Tensor:
        """(B, H, W, 3) uint8 numpy array or tensor -> tensor on the device."""
        if isinstance(frames_u8, np.ndarray):
            frames_u8 = torch.from_numpy(np.ascontiguousarray(frames_u8))
        if frames_u8.dtype != torch.uint8 or frames_u8.ndim != 4 \
                or tuple(frames_u8.shape[1:]) != (self.height, self.width, 3):
            raise ValueError(f"expected uint8 (B, {self.height}, {self.width}, "
                             f"3) frames, got {frames_u8.dtype} "
                             f"{tuple(frames_u8.shape)}")
        return frames_u8.to(self.device, non_blocking=True)

    def _depth(self, frames: torch.Tensor) -> torch.Tensor:
        return infer_depth(self.model, frames,
                           input_size=self.run_cfg.input_size)

    @torch.inference_mode()
    def step(self, frames_u8, state: TemporalState,
             n_valid: Optional[int] = None
             ) -> Tuple[torch.Tensor, TemporalState]:
        """One batch -> ((B, H, 2W, 3) uint8 SBS on the device, state').
        ``n_valid``: how many leading frames are real (the rest are padding
        copies); only those count toward the overflow tally."""
        frames = self.frames_to_device(frames_u8)
        blended, ranges, state = temporal_scan(self._depth(frames), state,
                                               self.spec, n_valid=n_valid)
        return self.spec.warp_batch(frames, blended, ranges), state

    def step_many(self, frames_u8, state: TemporalState):
        not_ported("SbsPipeline.step_many", "step_many")

    def primed_state(self, warm_frames, batch_size: int,
                     min_batches: int = 0) -> TemporalState:
        """State after feeding the frames [begin-W, begin), so a segment
        start continues the full-video sequence instead of resetting.
        Front-padding with copies of the first frame is exact at
        depth_stride 1 (copies are a fixed point of the cold start)."""
        state = self.initial_state()
        warm = np.asarray(warm_frames)
        n = warm.shape[0]
        if n == 0:
            return state
        k = max(-(-n // batch_size), min_batches)
        pad = k * batch_size - n
        if pad:
            warm = np.concatenate([np.repeat(warm[:1], pad, axis=0), warm])
        for i in range(k):
            _, state = self.step(warm[i * batch_size:(i + 1) * batch_size],
                                 state)
        # warm-up frames do not count toward the segment's overflow tally
        return state._replace(overflow=torch.zeros_like(state.overflow))

    @torch.inference_mode()
    def depth_only(self, frames_u8) -> torch.Tensor:
        """Depth maps at source resolution (scaled), (B, H, W) f32."""
        return self._depth(self.frames_to_device(frames_u8))
