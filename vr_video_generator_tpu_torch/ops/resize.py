"""Separable resampling as weight-matrix products (plain PyTorch).

The weight-matrix functions are copied from vr_video_generator_tpu/ops/resize.py
(that module imports jax): cv2 INTER_AREA (true area when the whole resize
shrinks, cv2's 2-tap zoom emulation otherwise), torch bilinear and bicubic
(A = -0.75, border taps clamped) with align_corners or a given scale. Each
resize applies one (n_out, n_in) matrix along H, then one along W.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "area_weights", "linear_weights", "cubic_weights", "area_zoom_weights",
    "area_or_linear_weights", "resize_area_cv2", "resize_bilinear",
    "resize_bicubic",
]


@functools.lru_cache(maxsize=None)
def area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of exact area (box-average) downsampling."""
    s = n_in / n_out
    w = np.zeros((n_out, n_in), np.float64)
    for k in range(n_out):
        a, b = k * s, (k + 1) * s
        i0 = int(np.floor(a))
        i1 = min(int(np.ceil(b)), n_in)
        for i in range(i0, i1):
            w[k, i] = (min(i + 1.0, b) - max(float(i), a)) / s
    return w


@functools.lru_cache(maxsize=None)
def linear_weights(n_in: int, n_out: int, align_corners: bool = False,
                   scale: Optional[float] = None,
                   cv2_edge_clamp: bool = False) -> np.ndarray:
    """(n_out, n_in) bilinear weights (torch semantics; cv2 edge clamp on
    request)."""
    w = np.zeros((n_out, n_in), np.float64)
    if n_out == 1 and align_corners:
        w[0, 0] = 1.0
        return w
    for k in range(n_out):
        if align_corners:
            src = k * (n_in - 1) / max(n_out - 1, 1)
        else:
            sc = scale if scale is not None else n_out / n_in
            src = (k + 0.5) / sc - 0.5
        x0 = int(np.floor(src))
        t = src - x0
        if cv2_edge_clamp:
            if x0 < 0:
                x0, t = 0, 0.0
            if x0 >= n_in - 1:
                x0, t = n_in - 2, 1.0
                if n_in == 1:
                    x0, t = 0, 0.0
        w[k, np.clip(x0, 0, n_in - 1)] += 1.0 - t
        w[k, np.clip(x0 + 1, 0, n_in - 1)] += t
    return w


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel (Keys), A=-0.75 as in torch/cv2."""
    t = np.abs(t)
    t2, t3 = t * t, t * t * t
    return np.where(
        t <= 1.0,
        (a + 2.0) * t3 - (a + 3.0) * t2 + 1.0,
        np.where(t < 2.0, a * t3 - 5.0 * a * t2 + 8.0 * a * t - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=None)
def cubic_weights(n_in: int, n_out: int, align_corners: bool = False,
                  scale: Optional[float] = None) -> np.ndarray:
    """(n_out, n_in) bicubic weights with torch border semantics."""
    w = np.zeros((n_out, n_in), np.float64)
    for k in range(n_out):
        if align_corners:
            src = k * (n_in - 1) / max(n_out - 1, 1) if n_out > 1 else 0.0
        else:
            sc = scale if scale is not None else n_out / n_in
            src = (k + 0.5) / sc - 0.5
        x0 = int(np.floor(src))
        t = src - x0
        taps = np.array([x0 - 1, x0, x0 + 1, x0 + 2])
        wt = _cubic_kernel(np.array([t + 1.0, t, 1.0 - t, 2.0 - t]))
        for tap, wv in zip(np.clip(taps, 0, n_in - 1), wt):
            w[k, tap] += wv
    return w


@functools.lru_cache(maxsize=None)
def area_zoom_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of cv2's INTER_AREA zoom emulation path."""
    scale = n_in / n_out
    inv = n_out / n_in
    w = np.zeros((n_out, n_in), np.float64)
    for dx in range(n_out):
        sx = int(np.floor(dx * scale))
        fx = (dx + 1) - (sx + 1) * inv
        fx = 0.0 if fx <= 0 else fx - np.floor(fx)
        if sx < 0:
            sx, fx = 0, 0.0
        if sx >= n_in - 1:
            if n_in == 1:
                sx, fx = 0, 0.0
            else:
                sx, fx = n_in - 2, 1.0
        w[dx, sx] += 1.0 - fx
        w[dx, min(sx + 1, n_in - 1)] += fx
    return w


@functools.lru_cache(maxsize=None)
def area_or_linear_weights(n_in: int, n_out: int, zoom_mode: bool) -> np.ndarray:
    """cv2 INTER_AREA axis weights: true area when the WHOLE resize shrinks,
    otherwise cv2's 2-tap zoom emulation for both axes."""
    if zoom_mode:
        return area_zoom_weights(n_in, n_out)
    return area_weights(n_in, n_out)


# Device copies of the (cached, hence long-lived) host matrices, keyed by
# the matrix's identity; the entry keeps the matrix alive so its id stays
# unique.
_DEVICE_WEIGHTS: Dict[Tuple[int, torch.dtype, torch.device],
                      Tuple[np.ndarray, torch.Tensor]] = {}


def _device_weights(w: np.ndarray, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    key = (id(w), dtype, device)
    if key not in _DEVICE_WEIGHTS:
        _DEVICE_WEIGHTS[key] = (w, torch.as_tensor(w, dtype=dtype,
                                                   device=device))
    return _DEVICE_WEIGHTS[key][1]


def _apply_separable(x: torch.Tensor, wh: np.ndarray, ww: np.ndarray,
                     h_axis: int, w_axis: int,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Apply (n_out, n_in) matrices along h_axis, then w_axis, computing in
    ``dtype`` (default: f32 or wider)."""
    compute = dtype or torch.promote_types(x.dtype, torch.float32)
    x = x.to(compute)
    for w, axis in ((wh, h_axis % x.ndim), (ww, w_axis % x.ndim)):
        m = _device_weights(w, compute, x.device)
        x = torch.movedim(torch.tensordot(x, m, dims=([axis], [1])), -1, axis)
    return x


def resize_area_cv2(x: torch.Tensor, out_hw: Tuple[int, int],
                    h_axis: int = -3, w_axis: int = -2) -> torch.Tensor:
    """cv2.resize(..., interpolation=INTER_AREA) parity resize (HWC default)."""
    h_in, w_in = x.shape[h_axis], x.shape[w_axis]
    zoom = out_hw[0] > h_in or out_hw[1] > w_in
    return _apply_separable(x, area_or_linear_weights(h_in, out_hw[0], zoom),
                            area_or_linear_weights(w_in, out_hw[1], zoom),
                            h_axis, w_axis)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    align_corners: bool = True, h_axis: int = -3,
                    w_axis: int = -2,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """torch F.interpolate(mode='bilinear') parity resize."""
    h_in, w_in = x.shape[h_axis], x.shape[w_axis]
    return _apply_separable(
        x, linear_weights(h_in, out_hw[0], align_corners=align_corners),
        linear_weights(w_in, out_hw[1], align_corners=align_corners),
        h_axis, w_axis, dtype=dtype)


def resize_bicubic(x: torch.Tensor, out_hw: Tuple[int, int],
                   align_corners: bool = True,
                   scale_hw: Optional[Tuple[float, float]] = None,
                   h_axis: int = -3, w_axis: int = -2) -> torch.Tensor:
    """torch F.interpolate(mode='bicubic') parity resize; ``scale_hw``
    reproduces torch's scale_factor mode (DINOv2 pos-embed)."""
    h_in, w_in = x.shape[h_axis], x.shape[w_axis]
    sh = scale_hw[0] if scale_hw else None
    sw = scale_hw[1] if scale_hw else None
    return _apply_separable(
        x, cubic_weights(h_in, out_hw[0], align_corners=align_corners, scale=sh),
        cubic_weights(w_in, out_hw[1], align_corners=align_corners, scale=sw),
        h_axis, w_axis)
