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
header for the design. At f32 (``--compute_dtype float32``) both rows run
the f32 chain of ``csrc/mlp_f32.cu`` (entry points ``vrvg_mlp_residual_f32``
where the JAX package keeps the f32 weights resident, as at D = 128 and
384, and ``vrvg_mlp_residual_hblocked_f32`` elsewhere, as at D = 768 and
1024; counted as ``mlp_residual_f32`` and ``mlp_residual_hblocked_f32``):
row 1's f32 LayerNorm, then fc1 and fc2 on the 3xTF32 wgmma core of
``csrc/tf32x3_gemm.cuh`` with b1 and the GELU (``approx``: the tanh GELU in
f32), and b2, LayerScale and the residual, in their epilogues;
:func:`fc1_gelu_kernel` launches its fc1 stage alone. That core takes each
weight as its TF32 hi/lo split (:func:`tf32x3_weight`), made by a kernel
once per weight and kept with it.

The SwiGLU half-block (vitg) replaces `swiglu_residual_pallas` (body
`_swiglu_kernel`, row 10): x + gamma * w3(silu(x1) * x2) with [x1 | x2] =
w12(LN2(x)), at the same rounding points, and with silu rounded as XLA rounds
``jax.nn.silu`` on bf16 (:func:`silu_mul`). Its kernel chain is
``csrc/swiglu.cu``, on the same GEMM core as rows 8 and 9: LayerNorm (row
1's kernel) -> the gate (h w12^T, + b12, silu(x1) * x2) -> the down product
with b3, LayerScale and the residual, with the LN rows and the (M, H) gate
output in scratch; :func:`swiglu_gate_plain` and :func:`fc2_residual_plain`
are the plain versions of its two GEMM stages. At f32 it runs the f32 chain
of ``csrc/swiglu_f32.cu`` (entry point ``vrvg_swiglu_residual_f32``,
counted as ``swiglu_residual_f32``): row 1's f32 LayerNorm, the gate on
the 3xTF32 core with w12 split in the gated order
(x1 and x2 of a g column in one thread) and b12 and silu(x1) * x2 in its
epilogue, then the down product with b3, LayerScale and the residual;
:func:`swiglu_gate_kernel` launches its gate stage alone. The plain version
(:func:`swiglu_residual_plain`) is one for both dtypes.

Every chain takes any D that is a multiple of 128 (the JAX kernels assert
it) and any hidden width: a custom ``ModelConfig``'s int(D * mlp_ratio),
or :func:`swiglu_hidden` at any ratio. The GEMM cores sum K in 64-wide
slices and row 10's gated tiles hold 128 (bf16) or 64 (f32) columns of x1
beside the same columns of x2, so the wrappers zero-pad the hidden width
to such a multiple (:func:`pad_hidden`: fc1's rows and b1, fc2's columns;
each half of w12 and b12, w3's columns), once per weight. The padding is
exact: a padded column's fc1 sum is 0, + 0, and GELU(0) = 0 (A&S and
tanh), silu(0) * 0 = 0, so every product it meets in fc2 or w3 is an
exact zero, which leaves each f32 sum (and each 3xTF32 stage sum) as it
was.
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
F32_LAUNCHES = counter("mlp_residual_f32")
HBLOCKED_F32_LAUNCHES = counter("mlp_residual_hblocked_f32")
FC1_GELU_F32_LAUNCHES = counter("fc1_gelu_f32")
SWIGLU_F32_LAUNCHES = counter("swiglu_residual_f32")
SWIGLU_GATE_F32_LAUNCHES = counter("swiglu_gate_f32")
TF32X3_SPLIT_LAUNCHES = counter("tf32x3_split")
TF32X3_TILE = 128  # csrc/tf32x3_gemm.cuh's BN: the split planes' row step
HIDDEN_STEP = 64   # the GEMM cores' K slice: a padded hidden's multiple
# Row 10's gated tile: 128 columns of x1 and of x2 at bf16 (csrc/swiglu.cu
# on csrc/wgmma_gemm.cuh's 128 x 256 tile), 64 at f32 (csrc/swiglu_f32.cu).
GATED_STEP = {torch.bfloat16: 128, torch.float32: 64}


def swiglu_hidden(d: int, mlp_ratio: float = 4.0) -> int:
    """SwiGLUFFNFused's hidden width: 2/3 of the nominal, rounded up to 8."""
    return (int(int(d * mlp_ratio) * 2 / 3) + 7) // 8 * 8


def silu_mul(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """silu(x1) * x2 in x1's dtype, each operation rounded to it: XLA
    evaluates ``jax.nn.silu`` (x * logistic(x)) on bf16 as
    1 / (1 + exp(-x)) with a bf16 rounding after the exp, the add and the
    divide, then rounds x * s and the product with x2; on f32 the same
    operations, each rounded to f32 (row 10's f32 gate epilogue)."""
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


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero, the low 13 bits cleared (csrc/tf32x3.cuh rna: infinity
    passes, a NaN stays a NaN)."""
    u = x.contiguous().view(torch.int32)
    r = (u + 0x1000) & -0x2000
    special = (u & 0x7F800000) == 0x7F800000
    nan_bit = torch.where((u & 0x7FFFFF) != 0, 0x400000, 0).to(torch.int32)
    return torch.where(special, (u & -0x2000) | nan_bit, r).view(torch.float32)


def tf32x3_split_plain(x: torch.Tensor):
    """x (f32) as TF32 (hi, lo) with hi = rna(x), lo = rna(x - hi):
    csrc/tf32x3.cuh's split, bit for bit. hi + lo is x to about 2^-22 |x|;
    in f32 it is exact, and it is what a 3xTF32 product of x with 1 gives
    (the selection checks of the f32 epilogues)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def tf32x3_rows(rows: int, hidden: int = 0) -> int:
    """Rows of a weight's split planes (csrc/tf32x3_gemm.cuh split_rows):
    ``rows`` rounded up to TF32X3_TILE, or for row 10's gated w12 (``hidden``
    = H > 0, rows = 2H) 128 ceil(H / 64)."""
    if hidden:
        return TF32X3_TILE * -(-hidden // 64)
    return -(-rows // TF32X3_TILE) * TF32X3_TILE


def gated_rows(hidden: int) -> torch.Tensor:
    """The w12 row each row of the gated split holds (tf32x3::gated_row):
    in each 128-row tile t, rows u < 64 are x1 of hidden column 64 t + u and
    rows u >= 64 x2 of the same column; -1 past H."""
    p = torch.arange(tf32x3_rows(2 * hidden, hidden))
    c = 64 * (p // 128) + p % 64
    return torch.where(c >= hidden, -1,
                       torch.where(p % 128 < 64, c, hidden + c))


def tf32x3_weight_plain(w: torch.Tensor, hidden: int = 0) -> torch.Tensor:
    """w (N, K) f32 -> (2, Npad, K): its TF32 hi and lo planes as
    csrc/tf32x3_gemm.cuh's split_kernel writes them, rows padded with zeros
    to :func:`tf32x3_rows`; with ``hidden`` (row 10's w12) in
    :func:`gated_rows`' order."""
    rows = w.shape[0]
    p = torch.arange(tf32x3_rows(rows, hidden))
    src = (gated_rows(hidden) if hidden
           else p.masked_fill(p >= rows, -1)).to(w.device)
    picked = torch.where((src >= 0)[:, None], w.float()[src.clamp_min(0)],
                         torch.zeros((), device=w.device))
    return torch.stack(tf32x3_split_plain(picked))


def tf32x3_split_kernel(w: torch.Tensor, hidden: int = 0) -> torch.Tensor:
    """:func:`tf32x3_weight_plain` of w: the plain version for a CPU tensor,
    ``vrvg_tf32x3_split`` (csrc/tf32x3_split.cu) for a CUDA one, every call
    (:func:`tf32x3_weight` keeps its result)."""
    if not on_cuda(w):
        return tf32x3_weight_plain(w, hidden)
    rows, k = w.shape
    if w.dtype != torch.float32 or not w.is_contiguous() or k % 4 \
            or (hidden and rows != 2 * hidden):
        raise ValueError(f"tf32x3_split takes a contiguous f32 (N, K) weight, "
                         f"K a multiple of 4 (gated: N = 2H), got {w.dtype} "
                         f"{tuple(w.shape)} contiguous={w.is_contiguous()} "
                         f"hidden={hidden}")
    from vr_video_generator_tpu_torch.kernels.build import check, library

    out = torch.empty((2, tf32x3_rows(rows, hidden), k), dtype=torch.float32,
                      device=w.device)
    check(library().vrvg_tf32x3_split(w.data_ptr(), out.data_ptr(), rows, k,
                                      hidden, stream_handle(w.device)),
          "vrvg_tf32x3_split")
    TF32X3_SPLIT_LAUNCHES.count += 1
    return out


def tf32x3_weight(w: torch.Tensor, hidden: int = 0) -> torch.Tensor:
    """w's TF32 split (:func:`tf32x3_split_kernel`), made once and kept on
    w itself, keyed on its storage, version counter and ``hidden``, so a
    weight changed in place (``load_state_dict``) or given new data
    (``Module.to``) is split again. The split planes take twice the weight's
    bytes. Planes made inside a CUDA graph capture are not kept (a capture
    runs nothing, so ``pipeline.StepGraph``'s eager step splits the weights
    before it), nor those of a weight without a version counter (an
    inference tensor): such a weight is split at every call."""
    if not on_cuda(w):
        return tf32x3_weight_plain(w, hidden)
    versioned = not w.is_inference()
    key = (w.data_ptr(), w._version if versioned else None, hidden,
           tuple(w.shape))
    kept = getattr(w, "_vrvg_tf32x3", None)
    if versioned and kept is not None and kept[0] == key:
        return kept[1]
    out = tf32x3_split_kernel(w, hidden)
    if versioned and not (torch.cuda.is_available()
                          and torch.cuda.is_current_stream_capturing()):
        w._vrvg_tf32x3 = (key, out)
    return out


def padded_hidden(hidden: int, step: int = HIDDEN_STEP) -> int:
    """``hidden`` rounded up to a multiple of ``step``."""
    return -(-hidden // step) * step


def pad_hidden(t: torch.Tensor, hidden: int, hp: int, dim: int,
               halves: int = 1) -> torch.Tensor:
    """t with each of its ``halves`` blocks of ``hidden`` along ``dim``
    zero-padded to ``hp``: fc1's rows and b1 or fc2's and w3's columns (one
    block), w12's rows and b12 (two: x1's and x2's). t itself where hp ==
    hidden. Made once and kept on t, keyed on its storage, version counter
    and the padding, as :func:`tf32x3_weight` keeps its split (and made
    outside inference mode, so that the split of the padded weight is kept
    in turn); not kept where made inside a CUDA graph capture or for an
    inference tensor."""
    if hp == hidden:
        return t
    versioned = not t.is_inference()
    key = (t.data_ptr(), t._version if versioned else None, hidden, hp, dim,
           halves)
    kept = getattr(t, "_vrvg_padded", None)
    if versioned and kept is not None and kept[0] == key:
        return kept[1]
    with torch.inference_mode(False):
        blocks = []
        for blk in t.split(hidden, dim=dim):
            shape = list(blk.shape)
            shape[dim] = hp - hidden
            blocks += [blk, blk.new_zeros(shape)]
        out = torch.cat(blocks, dim=dim)
    if versioned and not (torch.cuda.is_available()
                          and torch.cuda.is_current_stream_capturing()):
        t._vrvg_padded = (key, out)
    return out


def resident(d: int, hidden: int, dtype: torch.dtype) -> bool:
    """Whether the JAX package runs the weights-resident kernel (row 8)
    rather than the hidden-blocked one (row 9): both weight matrices within
    10 MiB and the hidden width a multiple of 512 (mlp_pallas.py:273-274).
    Each row's wrapper takes the widths this gives it."""
    return 2 * d * hidden * dtype.itemsize <= 10 * 2 ** 20 and hidden % 512 == 0


def fc1_gelu_kernel(a: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    approx: bool = False) -> torch.Tensor:
    """:func:`fc1_gelu_plain` of f32 LayerNorm'd rows a (..., D): the plain
    version for CPU tensors, for CUDA tensors the f32 chain's fc1 stage
    alone (``vrvg_fc1_gelu_f32``; no CLI path calls this: it exposes the
    epilogue's GELU, for a check through a selection fc1)."""
    if not on_cuda(a, w1, b1):
        return fc1_gelu_plain(a, w1, b1, approx)
    d, hid = a.shape[-1], w1.shape[0]
    f32 = torch.float32
    _check_operands("fc1_gelu_f32", a, (("fc1 weight", w1, (hid, d), f32),
                                        ("fc1 bias", b1, (hid,), f32)), f32)
    from vr_video_generator_tpu_torch.kernels.build import check, library

    w1s = tf32x3_weight(w1)
    h = torch.empty((*a.shape[:-1], hid), dtype=f32, device=a.device)
    check(library().vrvg_fc1_gelu_f32(
        a.data_ptr(), w1s.data_ptr(), b1.data_ptr(), h.data_ptr(),
        a.numel() // d, d, hid, int(approx), stream_handle(a.device)),
        "vrvg_fc1_gelu_f32")
    FC1_GELU_F32_LAUNCHES.count += 1
    return h


def mlp_residual(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, gamma: torch.Tensor,
                 eps: float = 1e-6, approx: bool = False) -> torch.Tensor:
    """(..., D) -> (..., D): the plain version for CPU tensors, row 8's
    kernel chain for CUDA tensors (bf16 or f32, D a multiple of 128, where
    :func:`resident` holds); ``approx`` the tanh GELU."""
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
    if x.dtype == torch.float32:
        chain = ("mlp_residual_f32", F32_LAUNCHES)
    else:
        chain = ("mlp_residual", TANH_LAUNCHES if approx else LAUNCHES)
    return _gelu_mlp_stages(*chain, True, x, ln_w, ln_b, w1, b1, w2, b2,
                            gamma, eps, approx)


def mlp_residual_hblocked(x: torch.Tensor, ln_w: torch.Tensor,
                          ln_b: torch.Tensor, w1: torch.Tensor,
                          b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, gamma: torch.Tensor,
                          eps: float = 1e-6,
                          approx: bool = False) -> torch.Tensor:
    """(..., D) -> (..., D): the plain version for CPU tensors, row 9's
    kernel chain for CUDA tensors (bf16 or f32, D a multiple of 128, where
    :func:`resident` does not hold); ``approx`` the tanh GELU."""
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
    if x.dtype == torch.float32:
        chain = ("mlp_residual_hblocked_f32", HBLOCKED_F32_LAUNCHES)
    else:
        chain = ("mlp_residual_hblocked",
                 HBLOCKED_TANH_LAUNCHES if approx else HBLOCKED_LAUNCHES)
    return _gelu_mlp_stages(*chain, False, x, ln_w, ln_b, w1, b1, w2, b2,
                            gamma, eps, approx)


def _gelu_mlp_stages(kernel: str, launches, row8: bool, x: torch.Tensor,
                     ln_w: torch.Tensor, ln_b: torch.Tensor, w1: torch.Tensor,
                     b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                     gamma: torch.Tensor, eps: float, approx: bool = False):
    """The GELU MLP half stage by stage: (LN(x), GELU(fc1(.) + b1), the
    output), ``approx`` the tanh GELU. For CPU tensors, the plain versions
    of the stages, each shaped as x; for CUDA tensors, one launch of the
    entry point ``vrvg_<kernel>`` (row 8's where ``row8``, taking the widths
    :func:`resident` keeps resident, else row 9's, taking the others; its
    fc1 epilogue's tanh variant with ``approx``; an f32 chain where
    ``kernel`` ends in _f32), counted on ``launches``, whose scratch holds
    the first two as (M, .) with M the rows of x (the hidden activations
    without their zero padding)."""
    if not on_cuda(x, ln_w, ln_b, w1, b1, w2, b2, gamma):
        a = layernorm_plain(x, ln_w, ln_b, eps)
        h = fc1_gelu_plain(a, w1, b1, approx)
        return a, h, fc2_residual_plain(h, w2, b2, gamma, x)
    d, hid = x.shape[-1], w1.shape[0]
    _check_mlp_operands(kernel, x, ln_w, ln_b, w1, b1, w2, b2, gamma)
    if resident(d, hid, x.dtype) != row8:
        raise ValueError(f"{kernel} kernel takes the widths the JAX rule "
                         f"gives row {8 if row8 else 9} (resident "
                         f"{'true' if row8 else 'false'}), got D={d}, "
                         f"hidden {hid}, {x.dtype}")
    from vr_video_generator_tpu_torch.kernels.build import check, library

    m = x.numel() // d
    hp = padded_hidden(hid)
    w1 = pad_hidden(w1, hid, hp, 0)
    b1 = pad_hidden(b1, hid, hp, 0)
    w2 = pad_hidden(w2, hid, hp, 1)
    if x.dtype == torch.float32:  # the 3xTF32 core takes the weights split
        w1, w2 = tf32x3_weight(w1), tf32x3_weight(w2)
    # Scratch of the chain: the LayerNorm'd rows and the hidden activations.
    a = torch.empty((m, d), dtype=x.dtype, device=x.device)
    h = torch.empty((m, hp), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    check(getattr(library(), f"vrvg_{kernel}")(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
        a.data_ptr(), h.data_ptr(), out.data_ptr(), m, d, hp, eps,
        int(approx), stream_handle(x.device)), f"vrvg_{kernel}")
    launches.count += 1
    return a, h[:, :hid], out


def swiglu_residual(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                    w12: torch.Tensor, b12: torch.Tensor, w3: torch.Tensor,
                    b3: torch.Tensor, gamma: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """(..., D) -> (..., D): the plain version for CPU tensors, row 10's
    kernel chain for CUDA tensors (bf16 or f32, D a multiple of 128, any
    hidden width H, read from w3's shape)."""
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
    stages; for CUDA tensors, one launch of the kernel chain (bf16, or the
    f32 chain for f32 x), whose scratch holds the first two (the gate
    output without its zero padding)."""
    d, hid = x.shape[-1], w3.shape[-1]
    m = x.numel() // d
    if not on_cuda(x, ln_w, ln_b, w12, b12, w3, b3, gamma):
        h = layernorm_plain(x, ln_w, ln_b, eps).reshape(m, d)
        g = swiglu_gate_plain(h, w12, b12)
        return h, g, fc2_residual_plain(g, w3, b3, gamma,
                                        x.reshape(m, d)).reshape(x.shape)
    f32 = x.dtype == torch.float32
    kernel, launches = (("swiglu_residual_f32", SWIGLU_F32_LAUNCHES) if f32
                        else ("swiglu_residual", SWIGLU_LAUNCHES))
    if d % 128:
        raise ValueError(f"{kernel} kernel takes D a multiple of 128, got "
                         f"{d}")
    dt = torch.float32 if f32 else torch.bfloat16
    _check_operands(kernel, x, (
        ("LN weight", ln_w, (d,), torch.float32),
        ("LN bias", ln_b, (d,), torch.float32),
        ("w12 weight", w12, (2 * hid, d), dt),
        ("w12 bias", b12, (2 * hid,), dt),
        ("w3 weight", w3, (d, hid), dt),
        ("w3 bias", b3, (d,), dt),
        ("gamma", gamma, (d,), dt)), dt)
    from vr_video_generator_tpu_torch.kernels.build import check, library

    hp = padded_hidden(hid, GATED_STEP[dt])
    w12 = pad_hidden(w12, hid, hp, 0, halves=2)
    b12 = pad_hidden(b12, hid, hp, 0, halves=2)
    w3 = pad_hidden(w3, hid, hp, 1)
    if f32:  # the 3xTF32 core takes the weights split, w12 gated
        w12, w3 = tf32x3_weight(w12, hp), tf32x3_weight(w3)
    # Scratch of the chain: the LayerNorm'd rows and silu(x1) * x2.
    h = torch.empty((m, d), dtype=x.dtype, device=x.device)
    g = torch.empty((m, hp), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    check(getattr(library(), f"vrvg_{kernel}")(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w12.data_ptr(),
        b12.data_ptr(), w3.data_ptr(), b3.data_ptr(), gamma.data_ptr(),
        h.data_ptr(), g.data_ptr(), out.data_ptr(), m, d, hp, eps,
        stream_handle(x.device)), f"vrvg_{kernel}")
    launches.count += 1
    return h, g[:, :hid], out


def swiglu_gate_kernel(h: torch.Tensor, w12: torch.Tensor,
                       b12: torch.Tensor) -> torch.Tensor:
    """:func:`swiglu_gate_plain` of f32 LayerNorm'd rows h (..., D), w12
    (2H, D) and b12 (2H,) f32, D and H multiples of 4: the plain version for
    CPU tensors, for CUDA tensors row 10's f32 gate stage alone
    (``vrvg_swiglu_gate_f32``; no CLI path calls this: it exposes the
    epilogue's silu, for a check through a selection w12)."""
    if not on_cuda(h, w12, b12):
        return swiglu_gate_plain(h, w12, b12)
    d, hid = h.shape[-1], w12.shape[0] // 2
    f32 = torch.float32
    _check_operands("swiglu_gate_f32", h, (
        ("w12 weight", w12, (2 * hid, d), f32),
        ("w12 bias", b12, (2 * hid,), f32)), f32)
    from vr_video_generator_tpu_torch.kernels.build import check, library

    w12s = tf32x3_weight(w12, hid)
    g = torch.empty((*h.shape[:-1], hid), dtype=f32, device=h.device)
    check(library().vrvg_swiglu_gate_f32(
        h.data_ptr(), w12s.data_ptr(), b12.data_ptr(), g.data_ptr(),
        h.numel() // d, d, hid, stream_handle(h.device)),
        "vrvg_swiglu_gate_f32")
    SWIGLU_GATE_F32_LAUNCHES.count += 1
    return g


def _check_operands(kernel: str, x: torch.Tensor, operands,
                    x_dtype: torch.dtype = torch.bfloat16) -> None:
    """Raise unless x and each (name, tensor, shape, dtype) of ``operands``
    is contiguous with that shape and dtype (x: ``x_dtype``, any leading
    shape)."""
    for name, t, shape, dtype in (("x", x, tuple(x.shape), x_dtype),
                                  *operands):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{kernel} {name} must be contiguous {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)} "
                             f"contiguous={t.is_contiguous()}")


def _check_mlp_operands(kernel: str, x: torch.Tensor, ln_w: torch.Tensor,
                        ln_b: torch.Tensor, w1: torch.Tensor,
                        b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                        gamma: torch.Tensor) -> None:
    """Raise unless the operands are what the GELU half-block kernels take:
    D a multiple of 128, any hidden width H (w1's rows), activations and
    weights bf16 (f32 for an f32 chain, ``kernel`` ending in _f32), f32 LN
    affine, all contiguous."""
    d, hid = x.shape[-1], w1.shape[0]
    if d % 128:
        raise ValueError(f"{kernel} kernel takes D a multiple of 128, got "
                         f"{d}")
    f32 = torch.float32
    dt = f32 if kernel.endswith("_f32") else torch.bfloat16
    _check_operands(kernel, x, (
        ("LN weight", ln_w, (d,), f32), ("LN bias", ln_b, (d,), f32),
        ("fc1 weight", w1, (hid, d), dt), ("fc1 bias", b1, (hid,), dt),
        ("fc2 weight", w2, (d, hid), dt), ("fc2 bias", b2, (d,), dt),
        ("gamma", gamma, (d,), dt)), dt)
