"""Row LayerNorm with f32 statistics: the Triton kernel and its plain version.

Replaces vr_video_generator_tpu/ops/layernorm.py `layernorm` (Pallas body
`_ln_kernel`): bf16 rows in and out, mean/variance and the affine in f32,
eps 1e-6. At 1080p/vits it runs 28 times per step on (8 * 2443, 384) rows.

What bounds it on the H100: it reads and writes 384 bf16 per row and does a
few flops per element, so it is memory-bound (~37 MB per call, ~11 us at
3.35 TB/s). The plain version materialises f32 copies of the activations
several times; the kernel reads the bf16 rows once, keeps the statistics in
registers and writes bf16 once. A block reduction in Triton reaches the same
bandwidth bound as CUDA C++, so this kernel is Triton.
"""

from __future__ import annotations

import functools
import os

import torch

from vr_video_generator_tpu_torch.kernels import counter, on_cuda
from vr_video_generator_tpu_torch.kernels.build import BUILD_DIR

LAUNCHES = counter("layernorm")
ROWS_PER_PROGRAM = 16

# Bound on first launch (this module must import without triton, which only
# the GPU machine has); the jitted kernel resolves ``tl`` from these globals.
triton = None
tl = None


def layernorm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics and affine."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    # Triton caches its compiled kernels beside the CUDA build.
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def ln_kernel(x_ptr, w_ptr, b_ptr, y_ptr, n_rows, d, eps,
                  BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < d
        mask = (rows < n_rows)[:, None] & cmask[None, :]
        offs = rows[:, None].to(tl.int64) * d + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=1) / d
        xc = tl.where(mask, x - mean[:, None], 0.0)
        var = tl.sum(xc * xc, axis=1) / d
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        y = xc * rstd[:, None] * w[None, :] + b[None, :]
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return ln_kernel


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm of (..., D): the plain version for CPU tensors, the Triton
    kernel for CUDA tensors."""
    if not on_cuda(x, weight, bias):
        return layernorm_plain(x, weight, bias, eps)
    d = x.shape[-1]
    if not x.is_contiguous() or weight.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"layernorm kernel needs contiguous (..., {d}) rows "
                         f"and ({d},) affine; got {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")
    kernel = _triton_kernel()
    n_rows = x.numel() // d
    y = torch.empty_like(x)
    grid = (-(-n_rows // ROWS_PER_PROGRAM),)
    kernel[grid](x, weight.contiguous(), bias.contiguous(), y, n_rows, d, eps,
                 BLOCK_R=ROWS_PER_PROGRAM, BLOCK_D=1 << (d - 1).bit_length(), num_warps=4)
    LAUNCHES.count += 1
    return y
