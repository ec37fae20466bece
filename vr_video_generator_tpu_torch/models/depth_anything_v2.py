"""Depth-Anything-V2: DINOv2 encoder + DPT head, and ``infer_depth``.

Mirrors vr_video_generator_tpu/models/depth_anything_v2.py.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from vr_video_generator_tpu_torch.utils.config import ModelConfig
from vr_video_generator_tpu_torch.models.dinov2 import (DinoVisionTransformer,
                                                        group_block)
from vr_video_generator_tpu_torch.models.dpt import DPTHead
from vr_video_generator_tpu_torch.ops.preprocess import (network_input_size,
                                                          preprocess_frames)
from vr_video_generator_tpu_torch.ops.resize import resize_bicubic
from vr_video_generator_tpu_torch.parallel.collectives import (broadcast_,
                                                               device_scope)


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuBLAS products and cuDNN convolutions, restored on
    exit. An f32 model computes in f32: TF32 (PyTorch's default for f32
    convolutions) keeps 10 mantissa bits, about three decimal digits."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


class DepthAnythingV2(nn.Module):
    """Forward over preprocessed input (B, Hn, Wn, 3) -> (B, Hn, Wn) depth.

    ``dtype`` is the compute dtype of the activations; the factory casts
    the weights to it (LayerNorm parameters and the pos-embed stay f32).
    ``cfg.mlp_fused`` and ``tail`` pick the encoder's and the head's fused
    paths (models/dinov2.resolve_block_fusion, models/dpt.resolve_tail), as
    in the JAX package (its ``DepthAnythingV2(tail=...)``). An f32
    model's forward runs with TF32 off (:func:`no_tf32`), also inside a
    CUDA graph's capture. With ``group`` > 1 it is rank ``rank`` of a model
    group (:class:`ModelGroup`) and holds that rank's shards.
    """

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                 tail: str = "auto", group: int = 1, rank: int = 0):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.pretrained = DinoVisionTransformer(cfg, group, rank)
        self.depth_head = DPTHead(cfg, tail=tail)

    def scope(self):
        return no_tf32() if self.dtype == torch.float32 \
            else contextlib.nullcontext()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.cfg.patch_size
        ph, pw = x.shape[1] // p, x.shape[2] // p
        with self.scope():
            taps = self.pretrained(x.to(self.dtype),
                                   self.cfg.intermediate_layers)
            return F.relu(self.depth_head(taps, ph, pw))


class ModelGroup(nn.Module):
    """One data slot's model group: ``ranks[r]`` is rank r's
    DepthAnythingV2 on its device, holding its shards of the split
    parameters and every other parameter whole (parallel/sharding.py,
    models/factory.build_group). The forward takes the input on the first
    rank's device, as a DepthAnythingV2's: the preprocessed frames, the
    patch embedding and the pos-embed run there and the tokens are
    broadcast to the group; the blocks run split across it
    (models/dinov2.group_block); the taps and the DPT head run on the first
    rank, since the rules replicate the head. ``cfg`` and ``dtype`` are the
    group's, as :func:`infer_depth` reads them."""

    def __init__(self, ranks):
        super().__init__()
        self.ranks = nn.ModuleList(ranks)
        self.cfg, self.dtype = ranks[0].cfg, ranks[0].dtype
        self.devices = [next(r.parameters()).device for r in ranks]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        first = self.ranks[0]
        p = self.cfg.patch_size
        ph, pw = x.shape[1] // p, x.shape[2] // p
        with first.scope():
            tokens = first.pretrained.embed(x.to(self.dtype))
            xs = [tokens]
            for dev in self.devices[1:]:
                with device_scope(dev):
                    xs.append(torch.empty_like(tokens, device=dev))
            broadcast_(xs)
            layers = self.cfg.intermediate_layers
            tapped = {}
            for i in range(self.cfg.depth):
                xs = group_block([r.pretrained.blocks[i] for r in self.ranks],
                                 xs)
                if i in layers:
                    tapped[i] = first.pretrained.tap(xs[0])
            taps = tuple(tapped[i] for i in layers)
            return F.relu(first.depth_head(taps, ph, pw))


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
