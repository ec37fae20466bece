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
``flash_attention_f32``): a pass that splits K and V into TF32 halves in a
scratch buffer the wrapper allocates, then both products as 3xTF32 wgmma
(each f32 operand the sum of two TF32 values, three products into one f32
accumulator), an f32 softmax, nothing cast: 96-109 TFLOP/s on an H100
(PERF.md), a third of one f32 ``scaled_dot_product_attention`` call's time.

Those kernels take head dim 64, that of every published encoder. At any
other head dim (a custom ``ModelConfig``: 12 heads at D = 384, 6 at D =
768, 2 at D = 768), both rows launch kernel 1 (counted as
``attention_any``, ``flash_attention_any`` and their ``_f32`` twins):
``csrc/attention_any.cu`` at bf16, ``csrc/attention.cu``'s design (a TMA
ring, wgmma consumers, the online softmax on the accumulators) with the head
dim zero-padded to a multiple of 64 in 64-wide chunks, and
``csrc/attention_any_f32.cu`` at f32, ``csrc/attention_f32.cu``'s 3xTF32
design at any head dim; each block's shape by head dim from
``csrc/attention_any_plan.cuh``. At bf16, where TMA cannot read q, k and v
as they are (a head dim that is no multiple of 8, or strides that are no
multiple of 16 bytes: :func:`tma_reads`), a pad pass first writes them to
scratch with 16-byte rows; at f32 a split pass writes their TF32 hi/lo
planes to scratch (:func:`any_scratch_numel`). Both passes are part of the
launch. Row 17 takes the head dims the library flash kernel takes
(:func:`flash_takes`): past 4096 tokens, where it walks K in blocks, up to
128 and multiples of 128 above; at another it raises NotImplementedError,
as the library kernel does, on the CPU as on the card. Row 2 takes every
head dim, as ``oneshot_mha`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from vr_video_generator_tpu_torch.kernels import counter, on_cuda, stream_handle

# The launch counter of row 2 ("attention") or 17 ("flash_attention") by
# (row, f32, head dim other than 64): csrc/attention.cu, its f32 variant
# (_f32), and csrc/attention_any.cu at every other head dim (_any,
# _any_f32).
LAUNCHES = {(row, f32, any_dim): counter(row + ("_any" if any_dim else "")
                                         + ("_f32" if f32 else ""))
            for row in ("attention", "flash_attention")
            for f32 in (False, True) for any_dim in (False, True)}
HEAD_DIM = 64          # csrc/attention.cu and csrc/attention_f32.cu
FLASH_MIN_BLOCK = 128  # flash_attention.MIN_BLOCK_SIZE: the head dim rule
MAX_ONESHOT_TOKENS = 4096  # attention_pallas._MAX_SEQ
FLASH_BLOCK = 512          # ops/attention._FLASH_BLOCK
FLASH_ONE_BLOCK = 4096     # _flash_mha: one K block up to this padded length
F32_KEY_TILE = 64          # csrc/attention_f32.cu BN: the split K/V's padding
# Kernel 1's f32 split pass (csrc/attention_any_f32.cu): rows padded to a
# multiple of ANY_F32_ROWS, head dims to one of ANY_F32_CHUNK.
ANY_F32_ROWS, ANY_F32_CHUNK = 128, 32
# The library kernel's logit for a masked key (flash_attention.DEFAULT_MASK_VALUE).
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


def oneshot_supported(n_tokens: int) -> bool:
    """Whether the one-shot function serves ``n_tokens`` tokens
    (attention_pallas.supported)."""
    return n_tokens <= MAX_ONESHOT_TOKENS


def flash_takes(head_dim: int, n_tokens: int) -> bool:
    """Whether the library flash kernel (row 17) takes ``head_dim`` at
    ``n_tokens``: with one K block (``_flash_mha`` up to FLASH_ONE_BLOCK
    tokens, the library's single-step kernel) any head dim; with several,
    up to FLASH_MIN_BLOCK (128) or a multiple of it (the blocked kernel
    raises NotImplementedError otherwise)."""
    return (n_tokens <= FLASH_ONE_BLOCK or head_dim <= FLASH_MIN_BLOCK
            or head_dim % FLASH_MIN_BLOCK == 0)


def check_flash_head_dim(head_dim: int, n_tokens: int) -> None:
    """Raise NotImplementedError, with the library kernel's rule, where it
    refuses the head dim (:func:`flash_takes`)."""
    if not flash_takes(head_dim, n_tokens):
        raise NotImplementedError(
            f"head_dim={head_dim} should be a multiple of {FLASH_MIN_BLOCK} "
            f"if larger: the library flash kernel (row 17) walks "
            f"{n_tokens} tokens in {FLASH_BLOCK}-key blocks, which take head "
            f"dims up to {FLASH_MIN_BLOCK} and multiples of "
            f"{FLASH_MIN_BLOCK} above")


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
    FLASH_BLOCK (512) keys once the padded length passes FLASH_ONE_BLOCK
    (4096; one block otherwise); per
    block s = f32(q k^T) * scale, the row max m, p = exp(s - m), the running
    sum l, and the output kept normalised: acc = acc * (l_corr / l) +
    f32(dtype(p) v) / l. Keys past N (the zero pad, masked to MASK_VALUE)
    add exactly nothing, so they are left out."""
    n = q.shape[1]
    total = n + (-n % FLASH_BLOCK)
    block_k = total if total <= FLASH_ONE_BLOCK else FLASH_BLOCK
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


def f32_scratch_numel(b: int, n: int, h: int, d: int = HEAD_DIM) -> int:
    """Floats of scratch an f32 attention launch takes at head dim ``d``:
    at 64, ``csrc/attention_f32.cu``'s K_hi, K_lo, V^T_hi and V^T_lo, each
    (B, H, N rounded up to 64, 64); at any other, kernel 1's split pass
    (``csrc/attention_any_pass.cu``): Q, K and V^T each as TF32 hi and lo
    planes of (B, H, N rounded up to ANY_F32_ROWS, Dh rounded up to
    ANY_F32_CHUNK)."""
    if d == HEAD_DIM:
        return 4 * b * h * -(-n // F32_KEY_TILE) * F32_KEY_TILE * HEAD_DIM
    npad = -(-n // ANY_F32_ROWS) * ANY_F32_ROWS
    return 6 * b * h * npad * -(-d // ANY_F32_CHUNK) * ANY_F32_CHUNK


def tma_reads(*views: torch.Tensor) -> bool:
    """Whether kernel 1's bf16 kernel reads ``views`` through TMA as they
    are: the head dim's rows and every token and batch stride multiples of
    16 bytes, 16-byte aligned (a qkv output's views at a head dim that is a
    multiple of 8)."""
    return all(x.shape[3] % 8 == 0 and x.stride(0) % 8 == 0
               and x.stride(1) % 8 == 0 and x.data_ptr() % 16 == 0
               for x in views)


def any_scratch_numel(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> int:
    """Elements (of q's dtype) of scratch kernel 1 takes for these views: at
    f32 the split pass's (:func:`f32_scratch_numel`); at bf16 none where TMA
    reads the views (:func:`tma_reads`), else the pad pass's q, k and v with
    rows of Dh rounded up to 8."""
    b, n, h, d = q.shape
    if q.dtype == torch.float32:
        return f32_scratch_numel(b, n, h, d)
    if tma_reads(q, k, v):
        return 0
    return 3 * b * n * h * -(-d // 8) * 8


def _launch(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float) -> torch.Tensor:
    """Check the layout and launch ``csrc/attention.cu``'s kernel (bf16) or
    ``csrc/attention_f32.cu``'s (f32, with its scratch) at head dim 64, and
    ``csrc/attention_any.cu``'s at any other head dim; the flash row
    multiplies the f32 logits by ``scale``."""
    b, n, h, d = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{kernel} kernel takes bf16 or f32, got {q.dtype}")
    if d != HEAD_DIM:
        return _launch_any(kernel, q, k, v, scale)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_layout(kernel, name, x, (b, n, h, d), q.dtype)
    from vr_video_generator_tpu_torch.kernels.build import check, library

    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    entry, scratch = f"vrvg_{kernel}", ()
    if q.dtype == torch.float32:
        entry += "_f32"
        ws = torch.empty(f32_scratch_numel(b, n, h, d), dtype=q.dtype,
                         device=q.device)
        scratch = (ws.data_ptr(),)
    err = getattr(library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, h,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), o.stride(0), o.stride(1), scale,
        *scratch, stream_handle(q.device))
    check(err, entry)
    return o


def _launch_any(kernel: str, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, scale: float) -> torch.Tensor:
    """Launch kernel 1 (``csrc/attention_any.cu``, at f32
    ``csrc/attention_any_f32.cu``) at q's head dim, with its pass's scratch
    (:func:`any_scratch_numel`): q, k and v need only their (H, Dh) pair
    contiguous, any token and batch stride (strided views into a qkv output
    at an odd head dim included)."""
    b, n, h, d = q.shape
    if d < 1:
        raise ValueError(f"{kernel} kernel: head dim must be >= 1, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype or tuple(x.shape) != (b, n, h, d) \
                or x.stride(3) != 1 or x.stride(2) != d:
            raise ValueError(f"{kernel} kernel: {name} must be {q.dtype} "
                             f"{(b, n, h, d)} with its (H, D) pair "
                             f"contiguous, got {x.dtype} {tuple(x.shape)} "
                             f"strides {x.stride()}")
    from vr_video_generator_tpu_torch.kernels.build import check, library

    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    ws = torch.empty(any_scratch_numel(q, k, v), dtype=q.dtype,
                     device=q.device)
    err = library().vrvg_attention_any(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, h, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), o.stride(0), o.stride(1), scale,
        int(kernel == "flash_attention"), int(q.dtype == torch.float32),
        ws.data_ptr() if ws.numel() else None, stream_handle(q.device))
    check(err, "vrvg_attention_any")
    return o


def _count(kernel: str, o: torch.Tensor) -> None:
    """One launch of ``kernel`` on its counter (LAUNCHES)."""
    LAUNCHES[(kernel, o.dtype == torch.float32,
              o.shape[3] != HEAD_DIM)].count += 1


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """(B, N, H, D) pre-scaled q, k, v -> (B, N, H, D): the plain version for
    CPU tensors, the kernel for CUDA tensors (bf16 or f32, any D; k and v
    may be strided views into a fused qkv output)."""
    if not on_cuda(q, k, v):
        return attention_plain(q, k, v)
    o = _launch("attention", q, k, v, 1.0)
    _count("attention", o)
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """(B, N, H, D) unscaled q, k, v -> (B, N, H, D) with the logits scaled
    in f32: the plain version for CPU tensors, the kernel for CUDA tensors
    (bf16 or f32; q, k and v may be strided views into a qkv output). A
    head dim the library kernel refuses at this length raises
    NotImplementedError on both (:func:`check_flash_head_dim`), before
    anything runs."""
    check_flash_head_dim(q.shape[3], q.shape[1])
    if not on_cuda(q, k, v):
        return flash_attention_plain(q, k, v, scale)
    o = _launch("flash_attention", q, k, v, scale)
    _count("flash_attention", o)
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
