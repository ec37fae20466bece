"""Multi-head attention of the ViT blocks: the CUDA kernel and its plain version.

Replaces vr_video_generator_tpu/ops/attention_pallas.py `oneshot_mha`
(Pallas body `_kernel`): non-causal softmax attention with q pre-scaled in
f32 and cast back, f32 logits and softmax, probabilities cast to the input
dtype for the PV product with f32 accumulation. The kernel is
``csrc/attention.cu``; see its header for the design.
"""

from __future__ import annotations

import torch

from vr_video_generator_tpu_torch.kernels import counter, on_cuda, stream_handle

LAUNCHES = counter("attention")
HEAD_DIM = 64


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


def _check_layout(name: str, x: torch.Tensor, shape) -> None:
    if x.dtype != torch.bfloat16 or tuple(x.shape) != shape:
        raise ValueError(f"attention kernel: {name} must be bf16 {shape}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.stride(3) != 1 or x.stride(2) != shape[3]:
        raise ValueError(f"attention kernel: {name} needs its (H, D) pair "
                         f"contiguous, got strides {x.stride()}")
    if x.stride(1) % 8 or x.stride(0) % 8 or x.data_ptr() % 16:
        raise ValueError(f"attention kernel: {name} rows must be 16-byte "
                         f"aligned, got strides {x.stride()}")


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """(B, N, H, D) pre-scaled q, k, v -> (B, N, H, D): the plain version for
    CPU tensors, the kernel for CUDA tensors (bf16, D = 64; k and v may be
    strided views into a fused qkv output)."""
    if not on_cuda(q, k, v):
        return attention_plain(q, k, v)
    b, n, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"attention kernel supports head_dim {HEAD_DIM}, "
                         f"got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, x, (b, n, h, d))
    from vr_video_generator_tpu_torch.kernels.build import check, library

    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    err = library().vrvg_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, h,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), o.stride(0), o.stride(1),
        stream_handle(q.device))
    check(err, "vrvg_attention")
    LAUNCHES.count += 1
    return o


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        scale: float) -> torch.Tensor:
    """q/k/v (B, N, H, D) -> (B, N, H, D). q is scaled in f32 and cast back
    to its dtype before the attention, as the TPU path does."""
    qs = (q.float() * scale).to(q.dtype)
    return attention(qs, k, v)
