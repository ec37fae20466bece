"""Separable Gaussian blur with torchvision parity (plain PyTorch).

Mirrors vr_video_generator_tpu/ops/gaussian.py: torchvision's sampled and
normalised 1-D kernels (kernel_wh = (kx, ky): width taps first), reflect
padding, the horizontal pass then the vertical one, each an f32 sum of the
taps in ascending order starting from zero.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """torchvision _get_gaussian_kernel1d: sampled pdf, normalized."""
    x = np.linspace(-(ksize - 1) * 0.5, (ksize - 1) * 0.5, ksize)
    pdf = np.exp(-0.5 * (x / sigma) ** 2)
    return (pdf / pdf.sum()).astype(np.float32)


def _blur_axis(x: torch.Tensor, kernel: np.ndarray, dim: int) -> torch.Tensor:
    """1-D blur of (B, C, H, W) f32 along H (dim=2) or W (dim=3)."""
    k = kernel.shape[0]
    n = x.shape[dim]
    pad = (k // 2, k // 2, 0, 0) if dim == 3 else (0, 0, k // 2, k // 2)
    xp = F.pad(x, pad, mode="reflect")
    out = torch.zeros_like(x)
    for t in range(k):
        out = out + float(kernel[t]) * xp.narrow(dim, t, n)
    return out


def gaussian_blur(img: torch.Tensor, kernel_wh: Tuple[int, int],
                  sigma: float) -> torch.Tensor:
    """Blur (B, H, W, C) input as f32; kernel_wh = (kx, ky)."""
    kx, ky = kernel_wh
    x = img.float().permute(0, 3, 1, 2)
    x = _blur_axis(x, gaussian_kernel1d(kx, sigma), dim=3)
    x = _blur_axis(x, gaussian_kernel1d(ky, sigma), dim=2)
    return x.permute(0, 2, 3, 1)
