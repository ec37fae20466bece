"""Row LayerNorm with f32 statistics: the CUDA kernel and its plain version.

Replaces vr_video_generator_tpu/ops/layernorm.py `layernorm` (Pallas body
`_ln_kernel`): bf16 rows in and out, mean/variance and the affine in f32,
eps 1e-6. It runs at every final-norm tap and, on the unfused paths, twice a
block: at 1080p, (8 * 2443, 384) rows 16 times a vits `auto` step, (8 *
4785, 1024) 28 times a vitl-728 step, (8 * 2443, 1536) 44 times a vitg-518
step.

What bounds it on the H100: it reads and writes D bf16 a row and does a few
flops an element, so it is bound by bytes (30 MB, 9 us at 3.35 TB/s, at
vits). The plain version materialises f32 copies of the activations several
times; the kernel (``csrc/layernorm.cu``: one warp a row, the row in
registers, 8- or 16-byte vector loads, a specialisation for each encoder
width and a generic one for any other) reads the bf16 rows once and writes
bf16 once. It was a Triton kernel (16 rows a program, D rounded up to a
power of two) until it measured 1.28x one ``F.layer_norm`` call at vits
with CUDA events around one call. On an H100 that gap was the host's:
Triton's launcher took ~63 us a call against ATen's ~21, while the Triton
kernel's own device time was 9 us against ``F.layer_norm``'s 31; at D =
1536 it ran 78 us against 61 (PERF.md, kernel table).
The CUDA kernel, called through the package's ctypes library, costs ~19 us
of host time a call.
"""

from __future__ import annotations

import torch

from vr_video_generator_tpu_torch.kernels import counter, on_cuda, stream_handle
from vr_video_generator_tpu_torch.kernels.build import check, library

LAUNCHES = counter("layernorm")


def layernorm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics and affine."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def _check_operands(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor) -> None:
    """Raise unless x is contiguous bf16 (..., D) and weight and bias are
    contiguous f32 (D,): what the kernel takes."""
    d = x.shape[-1]
    f32 = torch.float32
    if (x.dtype != torch.bfloat16 or weight.dtype != f32 or bias.dtype != f32
            or weight.shape != (d,) or bias.shape != (d,)
            or not (x.is_contiguous() and weight.is_contiguous()
                    and bias.is_contiguous())):
        raise ValueError(
            f"layernorm kernel needs contiguous bf16 (..., {d}) rows and "
            f"contiguous f32 ({d},) affine; got x {x.dtype} "
            f"{tuple(x.shape)} contiguous={x.is_contiguous()}, weight "
            f"{weight.dtype} {tuple(weight.shape)}, bias {bias.dtype} "
            f"{tuple(bias.shape)}")


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm of (..., D): the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if not on_cuda(x, weight, bias):
        return layernorm_plain(x, weight, bias, eps)
    _check_operands(x, weight, bias)
    d = x.shape[-1]
    y = torch.empty_like(x)
    check(library().vrvg_layernorm(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        x.numel() // d, d, eps, stream_handle(x.device)), "vrvg_layernorm")
    LAUNCHES.count += 1
    return y
