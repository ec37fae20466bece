"""DPT decoder head (PyTorch, NCHW inside).

Mirrors vr_video_generator_tpu/models/dpt.py: per-tap 1x1 projections, the
resize ladder (k=s ConvTranspose x4 / x2, identity, 3x3 stride-2 conv),
bias-free 3x3 ``layerN_rn`` convs, refinenets 4..1 with bilinear
align_corners upsampling through the resize matrices, and the output convs
ending in ReLU. Module names are the upstream state_dict names
(``depth_head.scratch.refinenet1.resConfUnit1.conv1.weight``, ...). The
convolutions outside the tail are cuDNN's, as XLA computes them outside any
Pallas kernel, and round as flax's (models/layers.py).

``tail`` picks the path after refinenet1's residual units
(:func:`resolve_tail`): "xla" runs refinenet1's upsample and out_conv and
the output convs here; "fused" hands refinenet1's pre-upsample activation
and the weights to ops/head_tail.head_tail_ext or, where the JAX package's
planners pick the big-C tail (vitl; vitb and vits at f32),
ops/head_tail.head_tail_big (the CUDA kernels on the card; at f32 their f32
variants), as the JAX package hands them to its Pallas tails.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vr_video_generator_tpu_torch.utils.config import ModelConfig
from vr_video_generator_tpu_torch.models.dinov2 import kernel_device
from vr_video_generator_tpu_torch.models.layers import Conv2d, ConvTranspose2d
from vr_video_generator_tpu_torch.ops import head_tail as head_tail_ops
from vr_video_generator_tpu_torch.ops.head_tail import (head_tail_big,
                                                        head_tail_ext)
from vr_video_generator_tpu_torch.ops.resize import resize_bilinear


TAILS = ("auto", "fused", "xla")


def resolve_tail(tail: str, pre_shape: Tuple[int, int, int, int],
                 dtype: torch.dtype, out_hw: Tuple[int, int],
                 device_type: str) -> Optional[str]:
    """Which fused tail the head runs for refinenet1's pre-upsample shape
    (B, H0, W0, C) in ``dtype``: "ext", "big" or None (unfused), as the JAX
    package resolves ``tail`` (its models/dpt.py DPTHead) with CUDA in the
    TPU's place. ``fused``, and ``auto`` on the card (``device_type`` is
    models.dinov2.kernel_device's), take the tail the JAX package's planners
    pick (ops/head_tail.plan_tail); ``xla``, and ``auto`` off the card, fuse
    nothing. Off the card the fused tails run their plain versions. The
    port's tails take every width the JAX kernels take, at bf16 and f32
    (ops/head_tail.takes; zero-padded on the card); where the planned
    tail's JAX kernel asserts on the width, this raises ValueError naming
    the assert, off and on the card alike, where the JAX package raises
    AssertionError."""
    if tail not in TAILS:
        raise ValueError(f"tail must be auto, fused or xla, got {tail!r}")
    if not (tail == "fused" or (tail == "auto" and device_type == "cuda")):
        return None
    choice = head_tail_ops.plan_tail(pre_shape, dtype, out_hw)
    if choice:
        head_tail_ops.check_takes(pre_shape[-1], choice)
    return choice


def _upsample(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear align_corners resize of (B, C, h, w) in x's dtype."""
    return resize_bilinear(x, out_hw, align_corners=True, h_axis=2, w_axis=3,
                           dtype=x.dtype)


class ResidualConvUnit(nn.Module):
    """relu-conv-relu-conv + skip (no batch norm)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1)
        self.conv2 = Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(F.relu(self.conv1(F.relu(x))))
        return out + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None,
                out_hw: Tuple[int, int] | None = None,
                pre_upsample: bool = False) -> torch.Tensor:
        """With ``pre_upsample``, the residual units' output, before the
        upsample and out_conv (the fused tail's input)."""
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        if pre_upsample:
            return x
        if out_hw is None:
            out_hw = (x.shape[2] * 2, x.shape[3] * 2)
        return self.out_conv(_upsample(x, out_hw))


class Scratch(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        feats = cfg.features
        for i, ch in enumerate(cfg.out_channels):
            setattr(self, f"layer{i + 1}_rn",
                    Conv2d(ch, feats, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(feats))
        self.output_conv1 = Conv2d(feats, feats // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            Conv2d(feats // 2, 32, 3, padding=1), nn.ReLU(),
            Conv2d(32, 1, 1), nn.ReLU())


class DPTHead(nn.Module):
    def __init__(self, cfg: ModelConfig, tail: str = "auto"):
        super().__init__()
        self.cfg, self.tail = cfg, tail
        oc = cfg.out_channels
        self.projects = nn.ModuleList(
            Conv2d(cfg.embed_dim, ch, 1) for ch in oc)
        self.resize_layers = nn.ModuleList([
            ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        self.scratch = Scratch(cfg)

    def forward(self, taps: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                ph: int, pw: int) -> torch.Tensor:
        """Taps -> (B, ph*14, pw*14) depth (before the model's final ReLU)."""
        out = []
        for i, (tokens, _cls) in enumerate(taps):
            b = tokens.shape[0]
            x = tokens.reshape(b, ph, pw, -1).permute(0, 3, 1, 2)
            x = self.resize_layers[i](self.projects[i](x))
            out.append(x)
        s = self.scratch
        rn = [getattr(s, f"layer{i + 1}_rn")(out[i]) for i in range(4)]
        path4 = s.refinenet4(rn[3], out_hw=tuple(rn[2].shape[2:]))
        path3 = s.refinenet3(path4, rn[2], out_hw=tuple(rn[1].shape[2:]))
        path2 = s.refinenet2(path3, rn[1], out_hw=tuple(rn[0].shape[2:]))
        out_hw = (ph * self.cfg.patch_size, pw * self.cfg.patch_size)
        pre_shape = (rn[0].shape[0], rn[0].shape[2], rn[0].shape[3],
                     self.cfg.features)
        fused = resolve_tail(self.tail, pre_shape, path2.dtype, out_hw,
                             kernel_device(path2))
        if fused:
            pre = s.refinenet1(path2, rn[0], pre_upsample=True)
            oc, c2 = s.refinenet1.out_conv, s.output_conv2
            tail = head_tail_big if fused == "big" else head_tail_ext
            return tail(pre.permute(0, 2, 3, 1), oc.weight, oc.bias,
                        s.output_conv1.weight, s.output_conv1.bias,
                        c2[0].weight, c2[0].bias, c2[2].weight, c2[2].bias,
                        out_hw)
        path1 = s.refinenet1(path2, rn[0])
        x = _upsample(s.output_conv1(path1), out_hw)
        return s.output_conv2(x)[:, 0]
