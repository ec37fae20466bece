"""The fused attention half-block's two ends: the CUDA kernels and their plain
versions.

Replaces vr_video_generator_tpu/ops/qkv_pallas.py:

* ``ln_qkv`` (``ln_qkv_pallas``, body ``_ln_qkv_kernel``): LN1 with f32
  statistics -> qkv GEMM -> cast to the compute dtype -> + bias in the
  compute dtype -> q = dtype(f32(q) * scale);
* ``proj_ls_residual`` (``proj_ls_residual_pallas``, body ``_proj_kernel``):
  the attention output -> proj GEMM -> cast -> + bias -> x + gamma * y, both
  rounded in the compute dtype.

The port's layout differs from the TPU's on purpose: ``ln_qkv`` returns
(B, N, 3, H, 64), whose q, k and v slices are the strided views the
attention kernel reads, with no pad rows (the port's attention masks keys
>= N itself). The kernels are ``csrc/qkv.cu``; see its header for the design.
``ln_qkv``'s is a chain: row 1's LayerNorm into an (M, D) scratch, then the
TMA + wgmma GEMM core with the bias and scale in its epilogue;
:func:`qkv_plain` is the plain version of that second stage.
``proj_ls_residual`` is one launch of the same core with the bias,
LayerScale and residual in its epilogue.

At f32 (``--compute_dtype float32``) both run their f32 variants
(``csrc/qkv_f32.cu``, counted as ``ln_qkv_f32`` and
``proj_ls_residual_f32``), where the JAX package plans the fused half at f32
(:func:`attn_fusable`): row 1's f32 LayerNorm, then the 3xTF32 wgmma GEMM
core of ``csrc/tf32x3_gemm.cuh`` with the same epilogues in f32. That core
takes each weight as its TF32 hi/lo split (``ops/mlp.tf32x3_weight``), made
by a kernel once per weight and kept with it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vr_video_generator_tpu_torch.kernels import counter, on_cuda, stream_handle
from vr_video_generator_tpu_torch.ops.layernorm import layernorm_plain
from vr_video_generator_tpu_torch.ops.mlp import tf32x3_weight

LN_QKV_LAUNCHES = counter("ln_qkv")
PROJ_LAUNCHES = counter("proj_ls_residual")
LN_QKV_F32_LAUNCHES = counter("ln_qkv_f32")
PROJ_F32_LAUNCHES = counter("proj_ls_residual_f32")
HEAD_DIM = 64
WIDTHS = (128, 384, 768, 1024)  # the widths csrc/qkv.cu is built for


def qkv_block_n(d: int, dtype: torch.dtype) -> int | None:
    """The JAX package's token block for its LN + qkv kernel
    (qkv_pallas._qkv_block_n): the largest of 512, 256, 128 whose VMEM plan
    (resident (D, 3D) weights, the x and h blocks, the f32 qkv product and
    its cast, three double-buffered outputs) fits 13 MiB, else None."""
    isz = dtype.itemsize
    for bn in (512, 256, 128):
        est = (3 * d * d * isz + bn * d * 2 * isz + bn * 3 * d * (4 + isz)
               + 3 * 2 * bn * d * isz)
        if est <= 13 * 2 ** 20:
            return bn
    return None


def attn_fusable(d: int, n: int, dtype: torch.dtype) -> bool:
    """qkv_pallas.attn_fusable: the JAX package fuses the attention half only
    where that plan exists (not at D=1024 in f32, nor at D=1536)."""
    return d % 128 == 0 and n >= 1 and qkv_block_n(d, dtype) is not None


def ln_qkv_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                 w: torch.Tensor, b: torch.Tensor, heads: int, scale: float,
                 eps: float = 1e-6) -> torch.Tensor:
    """(B, N, D) -> (B, N, 3, heads, D / heads): LN1, the qkv projection with
    the bias added after the cast, q pre-scaled in f32 and cast back."""
    return qkv_plain(layernorm_plain(x, ln_w, ln_b, eps), w, b, heads, scale)


def qkv_plain(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor, heads: int,
              scale: float) -> torch.Tensor:
    """Row 5's GEMM stage on LayerNorm'd rows ``a`` (B, N, D) -> (B, N, 3,
    heads, D / heads): the product cast to a's dtype, + bias in that dtype,
    q's third scaled in f32 (f64 stays f64) and cast back."""
    bsz, n, d = a.shape
    t = F.linear(a, w.to(a.dtype))
    t = (t + b.to(t.dtype)).reshape(bsz, n, 3, heads, d // heads)
    wide = torch.promote_types(t.dtype, torch.float32)
    q = (t[:, :, 0].to(wide) * scale).to(t.dtype)
    return torch.stack([q, t[:, :, 1], t[:, :, 2]], dim=2)


def proj_ls_residual_plain(o: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """attention output (B, N, H, Dh) and residual x (B, N, D) ->
    x + gamma * (proj(o) + b), each step rounded in x's dtype."""
    bsz, n, d = x.shape
    y = F.linear(o.reshape(bsz, n, d), w.to(x.dtype))
    y = y + b.to(y.dtype)
    return x + gamma.to(x.dtype) * y


def _check(name: str, t: torch.Tensor, shape, dtype) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def _check_width(kernel: str, d: int, heads: int) -> None:
    if d not in WIDTHS or d != heads * HEAD_DIM:
        raise ValueError(f"{kernel} kernel takes D in {WIDTHS} with head dim "
                         f"{HEAD_DIM}, got D={d}, heads={heads}")


def _kernel_dtype(kernel: str, x: torch.Tensor) -> torch.dtype:
    """The element type of a kernel's activations: bf16, or f32 for its f32
    variant; any other raises."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{kernel} kernel takes bf16 or f32 activations, "
                         f"got {x.dtype}")
    return x.dtype


def ln_qkv(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
           w: torch.Tensor, b: torch.Tensor, heads: int, scale: float,
           eps: float = 1e-6) -> torch.Tensor:
    """(B, N, D) -> (B, N, 3, heads, 64): the plain version for CPU tensors,
    the kernel chain for CUDA tensors (bf16; f32 through the f32 variant,
    weights and biases f32, the weight split once by
    :func:`~vr_video_generator_tpu_torch.ops.mlp.tf32x3_weight`)."""
    if not on_cuda(x, ln_w, ln_b, w, b):
        return ln_qkv_plain(x, ln_w, ln_b, w, b, heads, scale, eps)
    bsz, n, d = x.shape
    dt = _kernel_dtype("ln_qkv", x)
    _check_width("ln_qkv", d, heads)
    _check("ln_qkv x", x, (bsz, n, d), dt)
    _check("ln_qkv LN weight", ln_w, (d,), torch.float32)
    _check("ln_qkv LN bias", ln_b, (d,), torch.float32)
    _check("ln_qkv weight", w, (3 * d, d), dt)
    _check("ln_qkv bias", b, (3 * d,), dt)
    from vr_video_generator_tpu_torch.kernels.build import check, library

    f32 = dt == torch.float32
    if f32:  # the 3xTF32 core takes the weight split
        w = tf32x3_weight(w)
    # Scratch of the chain: the LayerNorm'd rows.
    a = torch.empty_like(x)
    out = torch.empty((bsz, n, 3, heads, HEAD_DIM), dtype=x.dtype,
                      device=x.device)
    entry = "vrvg_ln_qkv_f32" if f32 else "vrvg_ln_qkv"
    err = getattr(library(), entry)(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w.data_ptr(),
        b.data_ptr(), a.data_ptr(), out.data_ptr(), bsz * n, d, scale, eps,
        stream_handle(x.device))
    check(err, entry)
    (LN_QKV_F32_LAUNCHES if f32 else LN_QKV_LAUNCHES).count += 1
    return out


def proj_ls_residual(o: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """o (B, N, H, 64), x (B, N, D) -> x + gamma * (proj(o) + b): the plain
    version for CPU tensors, the kernel for CUDA tensors (bf16; f32 through
    the f32 variant, every operand f32, the weight split once by
    :func:`~vr_video_generator_tpu_torch.ops.mlp.tf32x3_weight`)."""
    if not on_cuda(o, x, w, b, gamma):
        return proj_ls_residual_plain(o, x, w, b, gamma)
    bsz, n, d = x.shape
    dt = _kernel_dtype("proj_ls_residual", x)
    _check_width("proj_ls_residual", d, o.shape[2])
    _check("proj_ls_residual o", o, (bsz, n, d // HEAD_DIM, HEAD_DIM), dt)
    _check("proj_ls_residual x", x, (bsz, n, d), dt)
    _check("proj_ls_residual weight", w, (d, d), dt)
    _check("proj_ls_residual bias", b, (d,), dt)
    _check("proj_ls_residual gamma", gamma, (d,), dt)
    from vr_video_generator_tpu_torch.kernels.build import check, library

    out = torch.empty_like(x)
    f32 = dt == torch.float32
    if f32:  # the 3xTF32 core takes the weight split
        w = tf32x3_weight(w)
    entry = "vrvg_proj_ls_residual_f32" if f32 else "vrvg_proj_ls_residual"
    err = getattr(library(), entry)(
        o.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
        gamma.data_ptr(), out.data_ptr(), bsz * n, d, stream_handle(x.device))
    check(err, entry)
    (PROJ_F32_LAUNCHES if f32 else PROJ_LAUNCHES).count += 1
    return out
