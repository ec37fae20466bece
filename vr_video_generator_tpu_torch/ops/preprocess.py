"""Depth-net input preprocessing: /255, cv2 INTER_AREA resize, ImageNet
normalize, in f32 (``exact``) or folded into bf16 products and one affine
(``folded``), as vr_video_generator_tpu/ops/preprocess.py computes them.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

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
    """uint8 RGB (B, H, W, 3) -> normalized (B, Hn, Wn, 3) network input.

    ``exact``: in f32 until the final cast (reference order: /255, resize,
    normalize). ``folded`` (the bf16 fast path): the pixels cast to
    ``dtype`` (exact for 0..255), both separable INTER_AREA products in
    ``dtype`` (H, then W; dense weight matrices, as the JAX package runs
    them by default), then ``x * scale + bias`` in ``dtype``, each op
    rounded, with /255 and the ImageNet normalize folded into scale and
    bias."""
    if impl == "folded":
        x = resize_area_cv2(frames_rgb_u8.to(dtype), net_hw, dtype=dtype)
        scale, bias = _folded_affine(x.device, dtype)
        return x * scale + bias
    if impl != "exact":
        raise ValueError(f"preprocess must be 'exact' or 'folded', got "
                         f"{impl!r}")
    x = frames_rgb_u8.to(torch.float32) / 255.0
    x = resize_area_cv2(x, net_hw)
    mean, std = _imagenet_stats(x.device)
    return ((x - mean) / std).to(dtype)


# Made once per device (and dtype): a host-to-device copy in every step would
# make the host wait for the device's queue to drain.
@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(IMAGENET_MEAN, device=device),
            torch.as_tensor(IMAGENET_STD, device=device))


@functools.lru_cache(maxsize=None)
def _folded_affine(device: torch.device,
                   dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The folded path's scale 1 / (255 std) and bias -mean / std, computed
    in f32 and cast to ``dtype``."""
    scale = 1.0 / (255.0 * IMAGENET_STD)
    bias = -IMAGENET_MEAN / IMAGENET_STD
    return (torch.as_tensor(scale, device=device).to(dtype),
            torch.as_tensor(bias, device=device).to(dtype))
