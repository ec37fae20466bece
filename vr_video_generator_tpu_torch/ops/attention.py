"""Multi-head attention of the ViT blocks: the CUDA kernels and their plain
versions, and the dispatch between them by token count.

Row 2 replaces vr_video_generator_tpu/ops/attention_pallas.py `oneshot_mha`
(Pallas body `_kernel`): non-causal softmax attention with q pre-scaled in
f32 and cast back, f32 logits and softmax, probabilities cast to the input
dtype for the PV product with f32 accumulation.

Row 17 replaces vr_video_generator_tpu/ops/attention.py `_flash_mha`, which
calls JAX's library flash kernel (`jax.experimental.pallas.ops.tpu.
flash_attention`, `_flash_attention_kernel_single_batch`) past 4096 tokens:
q, k, v unscaled, f32 logits times ``sm_scale`` in f32, keys >= N masked by
segment ids, an online softmax over 512-key blocks that keeps the output
normalised after every block, and probabilities cast to the input dtype for
the PV product.

``mha`` picks between them as the JAX package's does on its accelerator:
the one-shot function up to 4096 tokens, the flash function above. Both
kernels are ``csrc/attention.cu``; see its header for the design. At f32
(``--compute_dtype float32``) the wrappers launch the f32 variants of both
rows (``csrc/attention_f32.cu``, counted as ``attention_f32`` and
``flash_attention_f32``): FFMA products, an f32 softmax, nothing cast.
"""

from __future__ import annotations

import numpy as np
import torch

from vr_video_generator_tpu_torch.kernels import counter, on_cuda, stream_handle

LAUNCHES = counter("attention")
FLASH_LAUNCHES = counter("flash_attention")
F32_LAUNCHES = counter("attention_f32")
FLASH_F32_LAUNCHES = counter("flash_attention_f32")
HEAD_DIM = 64
MAX_ONESHOT_TOKENS = 4096  # attention_pallas._MAX_SEQ
FLASH_BLOCK = 512          # ops/attention._FLASH_BLOCK
# The library kernel's logit for a masked key (flash_attention.DEFAULT_MASK_VALUE).
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


def oneshot_supported(n_tokens: int) -> bool:
    """Whether the one-shot function serves ``n_tokens`` tokens
    (attention_pallas.supported)."""
    return n_tokens <= MAX_ONESHOT_TOKENS


def attention_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """(B, N, H, D) q (already scaled), k, v -> (B, N, H, D), one-shot
    softmax exactly as the TPU kernel computes it."""
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2)
    logits = qf @ kf.transpose(-1, -2)  # (B, H, N, N) f32
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(v.dtype).float() @ v.float().transpose(1, 2)) / l
    return o.to(q.dtype).transpose(1, 2).contiguous()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """(B, N, H, D) unscaled q, k, v -> (B, N, H, D), as the library flash
    kernel computes it with the JAX package's block sizes: K/V in blocks of
    512 keys once the padded length passes 4096 (one block otherwise); per
    block s = f32(q k^T) * scale, the row max m, p = exp(s - m), the running
    sum l, and the output kept normalised: acc = acc * (l_corr / l) +
    f32(dtype(p) v) / l. Keys past N (the zero pad, masked to MASK_VALUE)
    add exactly nothing, so they are left out."""
    n = q.shape[1]
    total = n + (-n % FLASH_BLOCK)
    block_k = total if total <= 4096 else FLASH_BLOCK
    qf = q.transpose(1, 2).float()                         # (B, H, N, D)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    shape = (*qf.shape[:3], 1)
    m = torch.full(shape, -torch.inf, device=q.device)
    l = torch.zeros(shape, device=q.device)
    acc = torch.zeros(qf.shape, device=q.device)
    for s0 in range(0, n, block_k):
        s = (qf @ kt[:, :, s0:s0 + block_k].float().transpose(-1, -2)) * scale
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_next)
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(dim=-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0, torch.ones_like(l_next), 1.0 / l_next)
        o_curr = p.to(v.dtype).float() @ vt[:, :, s0:s0 + block_k].float()
        acc = acc * (l_corr * inv) + o_curr * inv
        m, l = m_next, l_next
    return acc.to(q.dtype).transpose(1, 2).contiguous()


def _check_layout(kernel: str, name: str, x: torch.Tensor, shape,
                  dtype: torch.dtype) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{kernel} kernel: {name} must be {dtype} {shape}, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.stride(3) != 1 or x.stride(2) != shape[3]:
        raise ValueError(f"{kernel} kernel: {name} needs its (H, D) pair "
                         f"contiguous, got strides {x.stride()}")
    per16 = 16 // x.element_size()
    if x.stride(1) % per16 or x.stride(0) % per16 or x.data_ptr() % 16:
        raise ValueError(f"{kernel} kernel: {name} rows must be 16-byte "
                         f"aligned, got strides {x.stride()}")


def _launch(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float) -> torch.Tensor:
    """Check the layout and launch ``csrc/attention.cu``'s kernel (bf16) or
    ``csrc/attention_f32.cu``'s (f32), which multiplies the f32 logits by
    ``scale``."""
    b, n, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"{kernel} kernel supports head_dim {HEAD_DIM}, "
                         f"got {d}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{kernel} kernel takes bf16 or f32, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_layout(kernel, name, x, (b, n, h, d), q.dtype)
    from vr_video_generator_tpu_torch.kernels.build import check, library

    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    entry = f"vrvg_{kernel}" + ("_f32" if q.dtype == torch.float32 else "")
    err = getattr(library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, h,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), o.stride(0), o.stride(1), scale,
        stream_handle(q.device))
    check(err, entry)
    return o


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """(B, N, H, D) pre-scaled q, k, v -> (B, N, H, D): the plain version for
    CPU tensors, the kernel for CUDA tensors (bf16 or f32, D = 64; k and v
    may be strided views into a fused qkv output)."""
    if not on_cuda(q, k, v):
        return attention_plain(q, k, v)
    o = _launch("attention", q, k, v, 1.0)
    (F32_LAUNCHES if o.dtype == torch.float32 else LAUNCHES).count += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """(B, N, H, D) unscaled q, k, v -> (B, N, H, D) with the logits scaled
    in f32: the plain version for CPU tensors, the kernel for CUDA tensors
    (bf16 or f32, D = 64; q, k and v may be strided views into a qkv
    output)."""
    if not on_cuda(q, k, v):
        return flash_attention_plain(q, k, v, scale)
    o = _launch("flash_attention", q, k, v, scale)
    (FLASH_F32_LAUNCHES if o.dtype == torch.float32
     else FLASH_LAUNCHES).count += 1
    return o


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        scale: float) -> torch.Tensor:
    """q/k/v (B, N, H, D) -> (B, N, H, D), by token count as the JAX package
    runs it on its accelerator: up to 4096 tokens q is scaled in f32, cast
    back to its dtype and goes through the one-shot function; above, the
    flash function scales the f32 logits."""
    if oneshot_supported(q.shape[1]):
        qs = (q.float() * scale).to(q.dtype)
        return attention(qs, k, v)
    return flash_attention(q, k, v, scale)
