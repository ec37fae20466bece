"""The DPT head's tail from refinenet1's pre-upsample activation to depth: the
CUDA kernel chain and its plain version.

Replaces vr_video_generator_tpu/ops/head_tail_pallas.py
`head_tail_ext_pallas` (body `_tail_ext_kernel`):

    bilinear x2 (align corners) -> out_conv 1x1 -> output_conv1 3x3 ->
    bilinear to out_hw -> output_conv2 3x3 -> ReLU -> 1x1 -> ReLU

in the TPU kernel's order and at its rounding points: the out_conv channel
mix before the resizes (a 1x1 commutes with them), the W-resizes as GEMMs
with bf16 weights, the H-resizes as exact integer taps with an f32 lerp
(the out_conv bias added there, zero outside the image), conv1's f32 bias
added before its cast, conv2's f32 bias and ReLU, and the 1x1 in f32. The
kernels are ``csrc/head_tail.cu``; see its header for the design.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vr_video_generator_tpu_torch.kernels import counter, on_cuda, stream_handle
from vr_video_generator_tpu_torch.ops.resize import linear_weights

LAUNCHES = counter("head_tail_ext")
CHANNELS = (32, 64, 128)  # the feature widths csrc/head_tail.cu is built for
C3 = 32                   # output_conv2's width in the reference head


def takes(features: int) -> bool:
    """Whether the kernel chain is built for a head of ``features`` channels
    (vits 64, vitb 128; vitl's 256 is the big-C tail, not ported)."""
    return features in CHANNELS


def lerp_taps(n_in: int, n_out: int) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """Exact align-corners taps of an n_in -> n_out resize
    (head_tail_pallas._lerp_taps): rows i0, i1 and the f32 fraction t."""
    r = torch.arange(n_out, dtype=torch.int64)
    if n_out == 1:
        zero = torch.zeros(1, dtype=torch.int64)
        return zero, zero, torch.zeros(1)
    num = r * (n_in - 1)
    i0 = num // (n_out - 1)
    t = (num - i0 * (n_out - 1)).float() / float(n_out - 1)
    return i0, torch.clamp(i0 + 1, max=n_in - 1), t


def _hlerp(x: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    """(1 - t) * x[i0] + t * x[i1] along ``axis`` of an f32 tensor."""
    i0, i1, t = lerp_taps(x.shape[axis], n_out)
    shape = [1] * x.ndim
    shape[axis] = n_out
    t = t.to(x.device).reshape(shape)
    a = x.index_select(axis, i0.to(x.device))
    b = x.index_select(axis, i1.to(x.device))
    return (1 - t) * a + t * b


def head_tail_ext_plain(x: torch.Tensor, k_oc: torch.Tensor,
                        b_oc: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor,
                        k2: torch.Tensor, b2: torch.Tensor, k3: torch.Tensor,
                        b3: torch.Tensor, out_hw: Tuple[int, int]
                        ) -> torch.Tensor:
    """x (B, H0, W0, C) -> depth (B, H1, W1) f32. Weights in PyTorch layout:
    k_oc (C, C, 1, 1), k1 (C2, C, 3, 3), k2 (C3, C2, 3, 3), k3 (1, C3, 1,
    1); biases (out,)."""
    dt, f32 = x.dtype, torch.float32
    b, h0, w0, c = x.shape
    h1, w1 = out_hw
    xoc = (x.float() @ k_oc[:, :, 0, 0].to(dt).float().T).to(dt)
    wta = torch.as_tensor(linear_weights(w0, 2 * w0, align_corners=True),
                          dtype=dt, device=x.device).float()
    rw = torch.einsum("bhwc,vw->bhvc", xoc.float(), wta).to(dt)
    z = (_hlerp(rw.float(), 2 * h0, 1) + b_oc.to(f32)).to(dt)
    c1 = F.conv2d(z.permute(0, 3, 1, 2).float(), k1.to(dt).float(),
                  b1.to(f32), padding=1).to(dt)
    wtb = torch.as_tensor(linear_weights(2 * w0, w1, align_corners=True),
                          dtype=dt, device=x.device).float()
    c1w = torch.einsum("bchw,vw->bchv", c1.float(), wtb).to(dt)
    zz = _hlerp(c1w.float(), h1, 2).to(dt)
    y = F.relu(F.conv2d(zz.float(), k2.to(dt).float(), b2.to(f32), padding=1))
    res = (y * k3[0, :, 0, 0].to(f32)[:, None, None]).sum(dim=1) + b3.to(f32)
    return F.relu(res)


@functools.lru_cache(maxsize=None)
def _host_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per output column of the align-corners W-resize n_in -> n_out: the two
    input columns (int32, (2, n_out)) and their weights as bf16-rounded f32
    ((2, n_out)), from the same matrix the plain version multiplies by."""
    m = torch.as_tensor(linear_weights(n_in, n_out, align_corners=True),
                        dtype=torch.bfloat16).float().numpy()
    idx = np.zeros((2, n_out), np.int32)
    wts = np.zeros((2, n_out), np.float32)
    for k in range(n_out):
        cols = np.flatnonzero(m[k])
        if not 1 <= len(cols) <= 2:
            raise ValueError(f"resize row {k} has {len(cols)} taps")
        idx[:, k] = cols[0], cols[-1]
        wts[0, k] = m[k, cols[0]]
        wts[1, k] = m[k, cols[1]] if len(cols) == 2 else 0.0
    return idx, wts


_DEVICE_TAPS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _device_taps(n_in: int, n_out: int, device: torch.device):
    """The tap tables on ``device``, copied once (a copy inside a step would
    synchronise the stream)."""
    key = (n_in, n_out, device)
    if key not in _DEVICE_TAPS:
        idx, wts = _host_taps(n_in, n_out)
        _DEVICE_TAPS[key] = (torch.as_tensor(idx, device=device),
                             torch.as_tensor(wts, device=device))
    return _DEVICE_TAPS[key]


def head_tail_ext(x: torch.Tensor, k_oc: torch.Tensor, b_oc: torch.Tensor,
                  k1: torch.Tensor, b1: torch.Tensor, k2: torch.Tensor,
                  b2: torch.Tensor, k3: torch.Tensor, b3: torch.Tensor,
                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """x (B, H0, W0, C), any strides -> depth (B, H1, W1) f32: the plain
    version for CPU tensors, the kernel chain for CUDA tensors (bf16, C in
    ``CHANNELS``)."""
    args = (k_oc, b_oc, k1, b1, k2, b2, k3, b3)
    if not on_cuda(x, *args):
        return head_tail_ext_plain(x, *args, out_hw)
    b, h0, w0, c = x.shape
    h1, w1 = out_hw
    c2 = c // 2
    if x.dtype != torch.bfloat16 or not takes(c):
        raise ValueError(f"head_tail_ext kernel takes bf16 input with C in "
                         f"{CHANNELS}, got {x.dtype} C={c}")
    for name, t, shape in (("out_conv", k_oc, (c, c, 1, 1)),
                           ("output_conv1", k1, (c2, c, 3, 3)),
                           ("output_conv2.0", k2, (C3, c2, 3, 3)),
                           ("output_conv2.2", k3, (1, C3, 1, 1))):
        if tuple(t.shape) != shape:
            raise ValueError(f"head_tail_ext {name} weight must be {shape}, "
                             f"got {tuple(t.shape)}")
    from vr_video_generator_tpu_torch.kernels.build import check, library

    bf16, f32 = torch.bfloat16, torch.float32
    koc = k_oc[:, :, 0, 0].to(bf16).contiguous()
    wt1 = k1.to(bf16).permute(2, 3, 1, 0).contiguous()  # (3, 3, C, C2)
    wt2 = k2.to(bf16).permute(2, 3, 1, 0).contiguous()  # (3, 3, C2, C3)
    vecs = [t.to(f32).contiguous() for t in (b_oc, b1, b2, k3.reshape(-1), b3)]
    taps_a, tapw_a = _device_taps(w0, 2 * w0, x.device)
    taps_b, tapw_b = _device_taps(2 * w0, w1, x.device)
    rw = torch.empty((b, h0, 2 * w0, c), dtype=bf16, device=x.device)
    c1 = torch.empty((b, 2 * h0, 2 * w0, c2), dtype=bf16, device=x.device)
    out = torch.empty((b, h1, w1), dtype=f32, device=x.device)
    err = library().vrvg_head_tail_ext(
        x.data_ptr(), *x.stride(), b, h0, w0, c, koc.data_ptr(),
        vecs[0].data_ptr(), wt1.data_ptr(), vecs[1].data_ptr(),
        wt2.data_ptr(), vecs[2].data_ptr(), vecs[3].data_ptr(),
        vecs[4].data_ptr(), taps_a.data_ptr(), tapw_a.data_ptr(),
        taps_b.data_ptr(), tapw_b.data_ptr(), rw.data_ptr(), c1.data_ptr(),
        out.data_ptr(), h1, w1, stream_handle(x.device))
    check(err, "vrvg_head_tail_ext")
    LAUNCHES.count += 1
    return out
