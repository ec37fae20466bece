"""DPT decoder head (PyTorch, NCHW inside), plain-tail path.

Mirrors vr_video_generator_tpu/models/dpt.py with ``tail="xla"``: per-tap
1x1 projections, the resize ladder (k=s ConvTranspose x4 / x2, identity,
3x3 stride-2 conv), bias-free 3x3 ``layerN_rn`` convs, refinenets 4..1 with
bilinear align_corners upsampling through the resize matrices, and the
output convs ending in ReLU. Module names are the upstream state_dict names
(``depth_head.scratch.refinenet1.resConfUnit1.conv1.weight``, ...). The
convolutions are cuDNN's, as XLA computes them outside any Pallas kernel in
this configuration.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vr_video_generator_tpu.utils.config import ModelConfig
from vr_video_generator_tpu_torch.ops.resize import resize_bilinear


def _upsample(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear align_corners resize of (B, C, h, w) in x's dtype."""
    return resize_bilinear(x, out_hw, align_corners=True, h_axis=2, w_axis=3,
                           dtype=x.dtype)


class ResidualConvUnit(nn.Module):
    """relu-conv-relu-conv + skip (no batch norm)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(F.relu(self.conv1(F.relu(x))))
        return out + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None,
                out_hw: Tuple[int, int] | None = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        if out_hw is None:
            out_hw = (x.shape[2] * 2, x.shape[3] * 2)
        return self.out_conv(_upsample(x, out_hw))


class Scratch(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        feats = cfg.features
        for i, ch in enumerate(cfg.out_channels):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(ch, feats, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(feats))
        self.output_conv1 = nn.Conv2d(feats, feats // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(feats // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.ReLU())


class DPTHead(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        oc = cfg.out_channels
        self.projects = nn.ModuleList(
            nn.Conv2d(cfg.embed_dim, ch, 1) for ch in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
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
        path1 = s.refinenet1(path2, rn[0])
        x = s.output_conv1(path1)
        x = _upsample(x, (ph * self.cfg.patch_size, pw * self.cfg.patch_size))
        return s.output_conv2(x)[:, 0]
