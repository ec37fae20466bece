"""The MLP half-block in one CUDA kernel, and its plain version.

Replaces vr_video_generator_tpu/ops/mlp_pallas.py `mlp_residual_pallas`:
x + gamma * fc2(GELU(fc1(LN2(x)))) with LN in f32, each dense layer's
product cast to the compute dtype before its bias add, the A&S GELU in f32
(ops/gelu.py), and gamma * y and the residual add rounded in the compute
dtype. The JAX package runs it with the weights resident (body
`_kernel_resident`, row 8) where they fit in 10 MiB, at vits and vitb, and
hidden-blocked (body `_kernel`, row 9) above, at vitl; :func:`resident` is
its rule. Both compute the same function, so both wrappers share the plain
version, each with its own launch counter. Row 8 is ``csrc/mlp.cu``'s
kernel, one per width. Row 9 is ``csrc/mlp_hblocked.cu``'s chain of three
kernels on a TMA + wgmma GEMM core: LayerNorm (row 1's kernel) -> fc1 + b1 +
GELU -> fc2 + b2, LayerScale and residual, with the LN rows and the (M, 4D)
hidden activations in scratch; :func:`fc1_gelu_plain` and
:func:`fc2_residual_plain` are the plain versions of its two GEMM stages.
See the sources' headers for the designs.

The SwiGLU half-block (vitg) replaces `swiglu_residual_pallas` (body
`_swiglu_kernel`, row 10): x + gamma * w3(silu(x1) * x2) with [x1 | x2] =
w12(LN2(x)), at the same rounding points, and with silu rounded as XLA rounds
``jax.nn.silu`` on bf16 (:func:`silu_mul`). Its kernel chain is
``csrc/swiglu.cu``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vr_video_generator_tpu_torch.kernels import counter, on_cuda, stream_handle
from vr_video_generator_tpu_torch.ops.gelu import gelu_exact
from vr_video_generator_tpu_torch.ops.layernorm import layernorm_plain

LAUNCHES = counter("mlp_residual")
HBLOCKED_LAUNCHES = counter("mlp_residual_hblocked")
SWIGLU_LAUNCHES = counter("swiglu_residual")
WIDTHS = (128, 384, 768)  # row 8's widths in csrc/mlp.cu (hidden 4D)
HBLOCKED_WIDTHS = (1024,)  # row 9's
SWIGLU_WIDTHS = (1536,)    # row 10's in csrc/swiglu.cu (hidden 4096)


def swiglu_hidden(d: int, mlp_ratio: float = 4.0) -> int:
    """SwiGLUFFNFused's hidden width: 2/3 of the nominal, rounded up to 8."""
    return (int(int(d * mlp_ratio) * 2 / 3) + 7) // 8 * 8


def silu_mul(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """silu(x1) * x2 in x1's dtype, each operation rounded to it: XLA
    evaluates ``jax.nn.silu`` (x * logistic(x)) on bf16 as
    1 / (1 + exp(-x)) with a bf16 rounding after the exp, the add and the
    divide, then rounds x * s and the product with x2."""
    return x1 * (1 / (1 + torch.exp(-x1))) * x2


def swiglu_residual_plain(x: torch.Tensor, ln_w: torch.Tensor,
                          ln_b: torch.Tensor, w12: torch.Tensor,
                          b12: torch.Tensor, w3: torch.Tensor,
                          b3: torch.Tensor, gamma: torch.Tensor,
                          eps: float = 1e-6) -> torch.Tensor:
    """(..., D) -> x + gamma * (w3(silu(x1) * x2) + b3), [x1 | x2] =
    w12(LN(x)) + b12 split in halves; weights in PyTorch layout, w12
    (2H, D), w3 (D, H)."""
    dt = x.dtype
    h = layernorm_plain(x, ln_w, ln_b, eps)
    t = F.linear(h, w12.to(dt))
    t = t + b12.to(dt)
    x1, x2 = t.chunk(2, dim=-1)
    y = F.linear(silu_mul(x1, x2), w3.to(dt))
    y = y + b3.to(dt)
    return x + gamma.to(dt) * y


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


def fc1_gelu_plain(a: torch.Tensor, w1: torch.Tensor,
                   b1: torch.Tensor) -> torch.Tensor:
    """Row 9's second stage: GELU(fc1(a) + b1) on LayerNorm'd rows ``a``,
    the product cast to a's dtype before the bias add."""
    return gelu_exact(F.linear(a, w1.to(a.dtype)) + b1.to(a.dtype))


def fc2_residual_plain(h: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                       gamma: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Row 9's third stage: x + gamma * (fc2(h) + b2), each operation
    rounded to x's dtype."""
    dt = x.dtype
    return x + gamma.to(dt) * (F.linear(h, w2.to(dt)) + b2.to(dt))


def takes_width(d: int, ffn_layer: str = "mlp") -> bool:
    """Whether a kernel of the ``ffn_layer`` half-block is built for model
    width ``d``."""
    if ffn_layer == "swiglufused":
        return d in SWIGLU_WIDTHS
    return d in WIDTHS + HBLOCKED_WIDTHS


def resident(d: int, hidden: int, dtype: torch.dtype) -> bool:
    """Whether the JAX package runs the weights-resident kernel (row 8)
    rather than the hidden-blocked one (row 9): both weight matrices within
    10 MiB and the hidden width a multiple of 512 (mlp_pallas.py:273-274)."""
    return 2 * d * hidden * dtype.itemsize <= 10 * 2 ** 20 and hidden % 512 == 0


def mlp_residual(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, gamma: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """(..., D) -> (..., D): the plain version for CPU tensors, row 8's
    kernel for CUDA tensors (bf16, D in ``WIDTHS``, hidden 4D)."""
    if not on_cuda(x, ln_w, ln_b, w1, b1, w2, b2, gamma):
        return mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, gamma, eps)
    d = x.shape[-1]
    _check_mlp_operands("mlp_residual", WIDTHS, x, ln_w, ln_b, w1, b1, w2,
                        b2, gamma)
    from vr_video_generator_tpu_torch.kernels.build import check, library

    out = torch.empty_like(x)
    check(library().vrvg_mlp_residual(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
        out.data_ptr(), x.numel() // d, d, eps, stream_handle(x.device)),
        "vrvg_mlp_residual")
    LAUNCHES.count += 1
    return out


def mlp_residual_hblocked(x: torch.Tensor, ln_w: torch.Tensor,
                          ln_b: torch.Tensor, w1: torch.Tensor,
                          b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, gamma: torch.Tensor,
                          eps: float = 1e-6) -> torch.Tensor:
    """(..., D) -> (..., D): the plain version for CPU tensors, row 9's
    kernel chain for CUDA tensors (bf16, D in ``HBLOCKED_WIDTHS``, hidden
    4D)."""
    if not on_cuda(x, ln_w, ln_b, w1, b1, w2, b2, gamma):
        return mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, gamma, eps)
    return mlp_residual_hblocked_stages(x, ln_w, ln_b, w1, b1, w2, b2, gamma,
                                        eps)[2]


def mlp_residual_hblocked_stages(x: torch.Tensor, ln_w: torch.Tensor,
                                 ln_b: torch.Tensor, w1: torch.Tensor,
                                 b1: torch.Tensor, w2: torch.Tensor,
                                 b2: torch.Tensor, gamma: torch.Tensor,
                                 eps: float = 1e-6):
    """Row 9 stage by stage: (LN(x), GELU(fc1(.) + b1), the output), each
    (M, .) with M the rows of x. For CPU tensors, the plain versions of the
    stages; for CUDA tensors, one launch of the kernel chain, whose scratch
    holds the first two."""
    if not on_cuda(x, ln_w, ln_b, w1, b1, w2, b2, gamma):
        a = layernorm_plain(x, ln_w, ln_b, eps)
        h = fc1_gelu_plain(a, w1, b1)
        return a, h, fc2_residual_plain(h, w2, b2, gamma, x)
    d = x.shape[-1]
    _check_mlp_operands("mlp_residual_hblocked", HBLOCKED_WIDTHS, x, ln_w,
                        ln_b, w1, b1, w2, b2, gamma)
    from vr_video_generator_tpu_torch.kernels.build import check, library

    m = x.numel() // d
    # Scratch of the chain: the LayerNorm'd rows and the hidden activations.
    a = torch.empty((m, d), dtype=x.dtype, device=x.device)
    h = torch.empty((m, 4 * d), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    check(library().vrvg_mlp_residual_hblocked(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
        a.data_ptr(), h.data_ptr(), out.data_ptr(), m, d, eps,
        stream_handle(x.device)), "vrvg_mlp_residual_hblocked")
    HBLOCKED_LAUNCHES.count += 1
    return a, h, out


def swiglu_residual(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                    w12: torch.Tensor, b12: torch.Tensor, w3: torch.Tensor,
                    b3: torch.Tensor, gamma: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """(..., D) -> (..., D): the plain version for CPU tensors, row 10's
    kernel chain for CUDA tensors (bf16, D in ``SWIGLU_WIDTHS``, hidden
    :func:`swiglu_hidden`)."""
    if not on_cuda(x, ln_w, ln_b, w12, b12, w3, b3, gamma):
        return swiglu_residual_plain(x, ln_w, ln_b, w12, b12, w3, b3, gamma,
                                     eps)
    d = x.shape[-1]
    if d not in SWIGLU_WIDTHS:
        raise ValueError(f"swiglu_residual kernel takes D in {SWIGLU_WIDTHS}, "
                         f"got {d}")
    hid = swiglu_hidden(d)
    _check_operands("swiglu_residual", x, (
        ("LN weight", ln_w, (d,), torch.float32),
        ("LN bias", ln_b, (d,), torch.float32),
        ("w12 weight", w12, (2 * hid, d), torch.bfloat16),
        ("w12 bias", b12, (2 * hid,), torch.bfloat16),
        ("w3 weight", w3, (d, hid), torch.bfloat16),
        ("w3 bias", b3, (d,), torch.bfloat16),
        ("gamma", gamma, (d,), torch.bfloat16)))
    from vr_video_generator_tpu_torch.kernels.build import check, library

    m = x.numel() // d
    # Scratch of the chain: the LayerNorm'd rows and silu(x1) * x2.
    h = torch.empty_like(x)
    g = torch.empty((m, hid), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    err = library().vrvg_swiglu_residual(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w12.data_ptr(),
        b12.data_ptr(), w3.data_ptr(), b3.data_ptr(), gamma.data_ptr(),
        h.data_ptr(), g.data_ptr(), out.data_ptr(), m, d, hid, eps,
        stream_handle(x.device))
    check(err, "vrvg_swiglu_residual")
    SWIGLU_LAUNCHES.count += 1
    return out


def _check_operands(kernel: str, x: torch.Tensor, operands) -> None:
    """Raise unless x and each (name, tensor, shape, dtype) of ``operands``
    is contiguous with that shape and dtype (x: bf16, any leading shape)."""
    for name, t, shape, dtype in (("x", x, tuple(x.shape), torch.bfloat16),
                                  *operands):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{kernel} {name} must be contiguous {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)} "
                             f"contiguous={t.is_contiguous()}")


def _check_mlp_operands(kernel: str, widths, x: torch.Tensor,
                        ln_w: torch.Tensor, ln_b: torch.Tensor,
                        w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                        b2: torch.Tensor, gamma: torch.Tensor) -> None:
    """Raise unless the operands are what the GELU half-block kernels take:
    D in ``widths``, hidden 4D, bf16 activations and weights, f32 LN
    affine, all contiguous."""
    d = x.shape[-1]
    if d not in widths:
        raise ValueError(f"{kernel} kernel takes D in {widths}, got {d}")
    bf16, f32 = torch.bfloat16, torch.float32
    _check_operands(kernel, x, (
        ("LN weight", ln_w, (d,), f32), ("LN bias", ln_b, (d,), f32),
        ("fc1 weight", w1, (4 * d, d), bf16), ("fc1 bias", b1, (4 * d,), bf16),
        ("fc2 weight", w2, (d, 4 * d), bf16), ("fc2 bias", b2, (d,), bf16),
        ("gamma", gamma, (d,), bf16)))
