"""Depth-Anything-V2: DINOv2 encoder + DPT head, and ``infer_depth``.

Mirrors vr_video_generator_tpu/models/depth_anything_v2.py.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vr_video_generator_tpu_torch.utils.config import ModelConfig
from vr_video_generator_tpu_torch.models.dinov2 import DinoVisionTransformer
from vr_video_generator_tpu_torch.models.dpt import DPTHead
from vr_video_generator_tpu_torch.ops.preprocess import (network_input_size,
                                                          preprocess_frames)
from vr_video_generator_tpu_torch.ops.resize import resize_bicubic


class DepthAnythingV2(nn.Module):
    """Forward over preprocessed input (B, Hn, Wn, 3) -> (B, Hn, Wn) depth.

    ``dtype`` is the compute dtype of the activations; the factory casts
    the weights to it (LayerNorm parameters and the pos-embed stay f32).
    ``cfg.mlp_fused`` and ``tail`` pick the encoder's and the head's fused
    paths (models/dinov2.resolve_block_fusion, models/dpt.resolve_tail), as
    in the JAX package (its ``DepthAnythingV2(tail=...)``).
    """

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                 tail: str = "auto"):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.pretrained = DinoVisionTransformer(cfg)
        self.depth_head = DPTHead(cfg, tail=tail)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.cfg.patch_size
        ph, pw = x.shape[1] // p, x.shape[2] // p
        taps = self.pretrained(x.to(self.dtype), self.cfg.intermediate_layers)
        return F.relu(self.depth_head(taps, ph, pw))


def infer_depth(model: DepthAnythingV2, frames_rgb_u8: torch.Tensor,
                input_size: int = 518, preprocess: str = "exact") -> torch.Tensor:
    """uint8 RGB (B, H, W, 3) -> depth (B, H, W) f32: preprocess, forward,
    bicubic align_corners resize to the source size, times the encoder's
    depth scaler."""
    h, w = frames_rgb_u8.shape[1], frames_rgb_u8.shape[2]
    net_hw = network_input_size(h, w, target=input_size,
                                multiple_of=model.cfg.patch_size)
    x = preprocess_frames(frames_rgb_u8, net_hw, dtype=model.dtype,
                          impl=preprocess)
    depth = model(x).float()
    depth = resize_bicubic(depth, (h, w), align_corners=True, h_axis=1,
                           w_axis=2)
    return depth * model.cfg.depth_scaler
