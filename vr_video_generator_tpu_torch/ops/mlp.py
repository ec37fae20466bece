"""The MLP half-block as a CUDA kernel chain, and its plain version.

Replaces vr_video_generator_tpu/ops/mlp_pallas.py `mlp_residual_pallas`:
x + gamma * fc2(GELU(fc1(LN2(x)))) with LN in f32, each dense layer's
product cast to the compute dtype before its bias add, the A&S GELU in f32
(ops/gelu.py; with ``approx`` the tanh GELU, every operation rounded to the
compute dtype, ``gelu_tanh``), and gamma * y and the residual add rounded in
the compute dtype. The JAX package runs it with the weights resident (body
`_kernel_resident`, row 8) where they fit in 10 MiB, at vits and vitb, and
hidden-blocked (body `_kernel`, row 9) above, at vitl; :func:`resident` is
its rule. Both compute the same function, so both wrappers share the plain
version and the kernel chain of ``csrc/mlp_hblocked.cu``, each with its own
entry point (a tile shape per width) and launch counter: LayerNorm (row 1's
kernel) -> fc1 + b1 + GELU -> fc2 + b2, LayerScale and residual on a TMA +
wgmma GEMM core, with the LN rows and the (M, 4D) hidden activations in
scratch; :func:`fc1_gelu_plain` and :func:`fc2_residual_plain` are the
plain versions of its two GEMM stages, :func:`mlp_residual_stages` and
:func:`mlp_residual_hblocked_stages` return every stage. See the source's
header for the design.

The SwiGLU half-block (vitg) replaces `swiglu_residual_pallas` (body
`_swiglu_kernel`, row 10): x + gamma * w3(silu(x1) * x2) with [x1 | x2] =
w12(LN2(x)), at the same rounding points, and with silu rounded as XLA rounds
``jax.nn.silu`` on bf16 (:func:`silu_mul`). Its kernel chain is
``csrc/swiglu.cu``, on the same GEMM core as rows 8 and 9: LayerNorm (row
1's kernel) -> the gate (h w12^T, + b12, silu(x1) * x2) -> the down product
with b3, LayerScale and the residual, with the LN rows and the (M, H) gate
output in scratch; :func:`swiglu_gate_plain` and :func:`fc2_residual_plain`
are the plain versions of its two GEMM stages.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vr_video_generator_tpu_torch.kernels import counter, on_cuda, stream_handle
from vr_video_generator_tpu_torch.ops.gelu import gelu_exact, gelu_tanh
from vr_video_generator_tpu_torch.ops.layernorm import layernorm_plain

LAUNCHES = counter("mlp_residual")
HBLOCKED_LAUNCHES = counter("mlp_residual_hblocked")
# The chains with the tanh GELU in fc1's epilogue (--gelu tanh), counted
# apart from the exact ones.
TANH_LAUNCHES = counter("mlp_residual_tanh")
HBLOCKED_TANH_LAUNCHES = counter("mlp_residual_hblocked_tanh")
SWIGLU_LAUNCHES = counter("swiglu_residual")
SILU_MUL_LAUNCHES = counter("silu_mul")
GELU_TANH_LAUNCHES = counter("gelu_tanh")
WIDTHS = (128, 384, 768)  # row 8's widths (hidden 4D)
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


def silu_mul_kernel(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """:func:`silu_mul` of two bf16 tensors of one shape: the plain version
    for CPU tensors, for CUDA tensors the device function that row 10's gate
    epilogue applies, launched elementwise (no CLI path calls this; it
    exposes the epilogue's arithmetic for a check over every bf16 x1)."""
    if not on_cuda(x1, x2):
        return silu_mul(x1, x2)
    for name, t in (("x1", x1), ("x2", x2)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.shape != x1.shape:
            raise ValueError(f"silu_mul kernel {name} must be contiguous "
                             f"bf16 {tuple(x1.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    from vr_video_generator_tpu_torch.kernels.build import check, library

    out = torch.empty_like(x1)
    check(library().vrvg_silu_mul(x1.data_ptr(), x2.data_ptr(),
                                  out.data_ptr(), x1.numel(),
                                  stream_handle(x1.device)), "vrvg_silu_mul")
    SILU_MUL_LAUNCHES.count += 1
    return out


def gelu(x: torch.Tensor, approx: bool = False) -> torch.Tensor:
    """The MLP's GELU: the A&S erf form, or with ``approx`` the tanh form
    (``ModelConfig.gelu_approx``, ``--gelu tanh``)."""
    return gelu_tanh(x) if approx else gelu_exact(x)


def gelu_tanh_kernel(x: torch.Tensor) -> torch.Tensor:
    """:func:`ops.gelu.gelu_tanh` of a bf16 tensor: the plain version for
    CPU tensors, for CUDA tensors the device function that the tanh
    variant of rows 8 and 9's fc1 epilogue applies, launched elementwise
    (no CLI path calls this; it exposes the epilogue's arithmetic for a
    check over every bf16 input)."""
    if not on_cuda(x):
        return gelu_tanh(x)
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"gelu_tanh kernel takes contiguous bf16, got "
                         f"{x.dtype} contiguous={x.is_contiguous()}")
    from vr_video_generator_tpu_torch.kernels.build import check, library

    out = torch.empty_like(x)
    check(library().vrvg_gelu_tanh(x.data_ptr(), out.data_ptr(), x.numel(),
                                   stream_handle(x.device)), "vrvg_gelu_tanh")
    GELU_TANH_LAUNCHES.count += 1
    return out


def swiglu_gate_plain(h: torch.Tensor, w12: torch.Tensor,
                      b12: torch.Tensor) -> torch.Tensor:
    """Row 10's second stage: silu(x1) * x2 with [x1 | x2] = w12(h) + b12
    on LayerNorm'd rows ``h``, the product cast to h's dtype before the bias
    add."""
    dt = h.dtype
    x1, x2 = (F.linear(h, w12.to(dt)) + b12.to(dt)).chunk(2, dim=-1)
    return silu_mul(x1, x2)


def swiglu_residual_plain(x: torch.Tensor, ln_w: torch.Tensor,
                          ln_b: torch.Tensor, w12: torch.Tensor,
                          b12: torch.Tensor, w3: torch.Tensor,
                          b3: torch.Tensor, gamma: torch.Tensor,
                          eps: float = 1e-6) -> torch.Tensor:
    """(..., D) -> x + gamma * (w3(silu(x1) * x2) + b3), [x1 | x2] =
    w12(LN(x)) + b12 split in halves; weights in PyTorch layout, w12
    (2H, D), w3 (D, H). Its stages are row 10's kernel stages' plain
    versions."""
    g = swiglu_gate_plain(layernorm_plain(x, ln_w, ln_b, eps), w12, b12)
    return fc2_residual_plain(g, w3, b3, gamma, x)


def mlp_residual_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                       w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                       b2: torch.Tensor, gamma: torch.Tensor,
                       eps: float = 1e-6, approx: bool = False) -> torch.Tensor:
    """(..., D) -> x + gamma * (fc2(GELU(fc1(LN(x)) + b1)) + b2); ``approx``
    the tanh GELU."""
    dt = x.dtype
    h = layernorm_plain(x, ln_w, ln_b, eps)
    t = F.linear(h, w1.to(dt))
    t = t + b1.to(dt)
    y = F.linear(gelu(t, approx), w2.to(dt))
    y = y + b2.to(dt)
    return x + gamma.to(dt) * y


def fc1_gelu_plain(a: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   approx: bool = False) -> torch.Tensor:
    """The second stage of rows 8 and 9: GELU(fc1(a) + b1) on LayerNorm'd
    rows ``a``, the product cast to a's dtype before the bias add;
    ``approx`` the tanh GELU."""
    return gelu(F.linear(a, w1.to(a.dtype)) + b1.to(a.dtype), approx)


def fc2_residual_plain(h: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                       gamma: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The third stage of rows 8, 9 and 10: x + gamma * (fc2(h) + b2), each
    operation rounded to x's dtype (row 10: h the gate's output, w2 = w3)."""
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
                 eps: float = 1e-6, approx: bool = False) -> torch.Tensor:
    """(..., D) -> (..., D): the plain version for CPU tensors, row 8's
    kernel chain for CUDA tensors (bf16, D in ``WIDTHS``, hidden 4D);
    ``approx`` the tanh GELU."""
    if not on_cuda(x, ln_w, ln_b, w1, b1, w2, b2, gamma):
        return mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, gamma, eps,
                                  approx)
    return mlp_residual_stages(x, ln_w, ln_b, w1, b1, w2, b2, gamma, eps,
                               approx)[2]


def mlp_residual_stages(x: torch.Tensor, ln_w: torch.Tensor,
                        ln_b: torch.Tensor, w1: torch.Tensor,
                        b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                        gamma: torch.Tensor, eps: float = 1e-6,
                        approx: bool = False):
    """Row 8 stage by stage: (LN(x), GELU(fc1(.) + b1), the output); see
    :func:`_gelu_mlp_stages`."""
    return _gelu_mlp_stages("mlp_residual", WIDTHS,
                            TANH_LAUNCHES if approx else LAUNCHES, x, ln_w,
                            ln_b, w1, b1, w2, b2, gamma, eps, approx)


def mlp_residual_hblocked(x: torch.Tensor, ln_w: torch.Tensor,
                          ln_b: torch.Tensor, w1: torch.Tensor,
                          b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, gamma: torch.Tensor,
                          eps: float = 1e-6,
                          approx: bool = False) -> torch.Tensor:
    """(..., D) -> (..., D): the plain version for CPU tensors, row 9's
    kernel chain for CUDA tensors (bf16, D in ``HBLOCKED_WIDTHS``, hidden
    4D); ``approx`` the tanh GELU."""
    if not on_cuda(x, ln_w, ln_b, w1, b1, w2, b2, gamma):
        return mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, gamma, eps,
                                  approx)
    return mlp_residual_hblocked_stages(x, ln_w, ln_b, w1, b1, w2, b2, gamma,
                                        eps, approx)[2]


def mlp_residual_hblocked_stages(x: torch.Tensor, ln_w: torch.Tensor,
                                 ln_b: torch.Tensor, w1: torch.Tensor,
                                 b1: torch.Tensor, w2: torch.Tensor,
                                 b2: torch.Tensor, gamma: torch.Tensor,
                                 eps: float = 1e-6, approx: bool = False):
    """Row 9 stage by stage: (LN(x), GELU(fc1(.) + b1), the output); see
    :func:`_gelu_mlp_stages`."""
    return _gelu_mlp_stages("mlp_residual_hblocked", HBLOCKED_WIDTHS,
                            HBLOCKED_TANH_LAUNCHES if approx
                            else HBLOCKED_LAUNCHES, x, ln_w, ln_b, w1, b1, w2,
                            b2, gamma, eps, approx)


def _gelu_mlp_stages(kernel: str, widths, launches, x: torch.Tensor,
                     ln_w: torch.Tensor, ln_b: torch.Tensor, w1: torch.Tensor,
                     b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                     gamma: torch.Tensor, eps: float, approx: bool = False):
    """The GELU MLP half stage by stage: (LN(x), GELU(fc1(.) + b1), the
    output), ``approx`` the tanh GELU. For CPU tensors, the plain versions
    of the stages, each shaped as x; for CUDA tensors, one launch of the
    entry point ``vrvg_<kernel>`` (D in ``widths``; its fc1 epilogue's tanh
    variant with ``approx``), counted on ``launches``, whose scratch holds
    the first two as (M, .) with M the rows of x."""
    if not on_cuda(x, ln_w, ln_b, w1, b1, w2, b2, gamma):
        a = layernorm_plain(x, ln_w, ln_b, eps)
        h = fc1_gelu_plain(a, w1, b1, approx)
        return a, h, fc2_residual_plain(h, w2, b2, gamma, x)
    d = x.shape[-1]
    _check_mlp_operands(kernel, widths, x, ln_w, ln_b, w1, b1, w2, b2, gamma)
    from vr_video_generator_tpu_torch.kernels.build import check, library

    m = x.numel() // d
    # Scratch of the chain: the LayerNorm'd rows and the hidden activations.
    a = torch.empty((m, d), dtype=x.dtype, device=x.device)
    h = torch.empty((m, 4 * d), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    check(getattr(library(), f"vrvg_{kernel}")(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
        a.data_ptr(), h.data_ptr(), out.data_ptr(), m, d, eps, int(approx),
        stream_handle(x.device)), f"vrvg_{kernel}")
    launches.count += 1
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
    return swiglu_residual_stages(x, ln_w, ln_b, w12, b12, w3, b3, gamma,
                                  eps)[2]


def swiglu_residual_stages(x: torch.Tensor, ln_w: torch.Tensor,
                           ln_b: torch.Tensor, w12: torch.Tensor,
                           b12: torch.Tensor, w3: torch.Tensor,
                           b3: torch.Tensor, gamma: torch.Tensor,
                           eps: float = 1e-6):
    """Row 10 stage by stage: (LN(x), silu(x1) * x2, the output), each
    (M, .) with M the rows of x. For CPU tensors, the plain versions of the
    stages; for CUDA tensors, one launch of the kernel chain, whose scratch
    holds the first two."""
    d = x.shape[-1]
    m = x.numel() // d
    if not on_cuda(x, ln_w, ln_b, w12, b12, w3, b3, gamma):
        h = layernorm_plain(x, ln_w, ln_b, eps).reshape(m, d)
        g = swiglu_gate_plain(h, w12, b12)
        return h, g, fc2_residual_plain(g, w3, b3, gamma,
                                        x.reshape(m, d)).reshape(x.shape)
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

    # Scratch of the chain: the LayerNorm'd rows and silu(x1) * x2.
    h = torch.empty((m, d), dtype=x.dtype, device=x.device)
    g = torch.empty((m, hid), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    check(library().vrvg_swiglu_residual(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w12.data_ptr(),
        b12.data_ptr(), w3.data_ptr(), b3.data_ptr(), gamma.data_ptr(),
        h.data_ptr(), g.data_ptr(), out.data_ptr(), m, d, hid, eps,
        stream_handle(x.device)), "vrvg_swiglu_residual")
    SWIGLU_LAUNCHES.count += 1
    return h, g, out


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
