"""The MLP half-block in one CUDA kernel, and its plain version.

Replaces vr_video_generator_tpu/ops/mlp_pallas.py `mlp_residual_pallas` with
the weights resident (body `_kernel_resident`, taken at vits and vitb):
x + gamma * fc2(GELU(fc1(LN2(x)))) with LN in f32, each dense layer's
product cast to the compute dtype before its bias add, the A&S GELU in f32
(ops/gelu.py), and gamma * y and the residual add rounded in the compute
dtype. The kernel is ``csrc/mlp.cu``; see its header for the design.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vr_video_generator_tpu_torch.kernels import counter, on_cuda, stream_handle
from vr_video_generator_tpu_torch.ops.gelu import gelu_exact
from vr_video_generator_tpu_torch.ops.layernorm import layernorm_plain

LAUNCHES = counter("mlp_residual")
WIDTHS = (128, 384, 768)  # the widths csrc/mlp.cu is built for (hidden 4D)


def mlp_residual_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                       w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                       b2: torch.Tensor, gamma: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """(..., D) -> x + gamma * (fc2(GELU(fc1(LN(x)) + b1)) + b2)."""
    dt = x.dtype
    h = layernorm_plain(x, ln_w, ln_b, eps)
    t = F.linear(h, w1.to(dt))
    t = t + b1.to(dt)
    y = F.linear(gelu_exact(t), w2.to(dt))
    y = y + b2.to(dt)
    return x + gamma.to(dt) * y


def takes_width(d: int) -> bool:
    """Whether the kernel is built for model width ``d``."""
    return d in WIDTHS


def mlp_residual(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, gamma: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """(..., D) -> (..., D): the plain version for CPU tensors, the kernel
    for CUDA tensors (bf16, D in ``WIDTHS``, hidden 4D)."""
    if not on_cuda(x, ln_w, ln_b, w1, b1, w2, b2, gamma):
        return mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, gamma, eps)
    d = x.shape[-1]
    if not takes_width(d):
        raise ValueError(f"mlp_residual kernel takes D in {WIDTHS}, got {d}")
    bf16, f32 = torch.bfloat16, torch.float32
    for name, t, shape, dtype in (
            ("x", x, tuple(x.shape), bf16), ("LN weight", ln_w, (d,), f32),
            ("LN bias", ln_b, (d,), f32), ("fc1 weight", w1, (4 * d, d), bf16),
            ("fc1 bias", b1, (4 * d,), bf16), ("fc2 weight", w2, (d, 4 * d), bf16),
            ("fc2 bias", b2, (d,), bf16), ("gamma", gamma, (d,), bf16)):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"mlp_residual {name} must be contiguous {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)} "
                             f"contiguous={t.is_contiguous()}")
    from vr_video_generator_tpu_torch.kernels.build import check, library

    out = torch.empty_like(x)
    err = library().vrvg_mlp_residual(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
        out.data_ptr(), x.numel() // d, d, eps, stream_handle(x.device))
    check(err, "vrvg_mlp_residual")
    LAUNCHES.count += 1
    return out
