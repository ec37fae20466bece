"""Depth-net input preprocessing: /255, cv2 INTER_AREA resize, ImageNet
normalize (mirrors the exact path of vr_video_generator_tpu/ops/preprocess.py).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from vr_video_generator_tpu_torch import not_ported
from vr_video_generator_tpu_torch.ops.resize import resize_area_cv2

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def constrain_to_multiple_of(x: float, multiple_of: int, min_val: float = 0,
                             max_val: float | None = None) -> int:
    """Reference Resize.constrain_to_multiple_of."""
    y = int(round(x / multiple_of) * multiple_of)
    if max_val is not None and y > max_val:
        y = int(np.floor(x / multiple_of) * multiple_of)
    if y < min_val:
        y = int(np.ceil(x / multiple_of) * multiple_of)
    return y


def network_input_size(height: int, width: int, target: int = 518,
                       multiple_of: int = 14) -> Tuple[int, int]:
    """(H, W) the depth net sees: scale so both sides are at least
    ``target`` (lower_bound policy), each rounded to a multiple of 14."""
    scale = max(target / height, target / width)
    new_h = constrain_to_multiple_of(scale * height, multiple_of, min_val=target)
    new_w = constrain_to_multiple_of(scale * width, multiple_of, min_val=target)
    return new_h, new_w


def preprocess_frames(frames_rgb_u8: torch.Tensor, net_hw: Tuple[int, int],
                      dtype: torch.dtype = torch.float32,
                      impl: str = "exact") -> torch.Tensor:
    """uint8 RGB (B, H, W, 3) -> normalized (B, Hn, Wn, 3) network input,
    in f32 until the final cast (reference order: /255, resize, normalize)."""
    if impl != "exact":
        not_ported(f"preprocess={impl!r}", "folded preprocess")
    x = frames_rgb_u8.to(torch.float32) / 255.0
    x = resize_area_cv2(x, net_hw)
    mean, std = _imagenet_stats(x.device)
    return ((x - mean) / std).to(dtype)


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    # Made once per device: a host-to-device copy in every step would make
    # the host wait for the device's queue to drain.
    return (torch.as_tensor(IMAGENET_MEAN, device=device),
            torch.as_tensor(IMAGENET_STD, device=device))
