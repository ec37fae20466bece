"""refinenet1's residual-unit pair, rcu2(path2 + rcu1(rn0)): the CUDA kernel
chain (csrc/rcu_pair.cu) and its plain version.

Replaces vr_video_generator_tpu/attic/refinenet_pre.py
`refinenet_pre_pallas` (body `_rcu_pair_kernel`, row 16). Like it, this
lies on no CLI path: the JAX package's DPT head runs refinenet1's units
unfused (its models/dpt.py notes that the fused pair measured slower than
XLA's convolutions on the TPU), and so does the port's head.

ResidualConvUnit (reference util/blocks.py:29-80): out = conv2(relu(conv1(
relu(x)))) + x, wired as refinenet1's prologue: t = path2 + rcu1(rn0), out =
rcu2(t). The rounding points are the TPU kernel's (:92-121): each conv's
accumulator starts at its f32 bias, ReLU on the loaded input and on the
f32 output where the unit has one, the residuals added in f32 in the
kernel's order (acc + rn0 + path2, then acc + t), zero outside the image
before each conv, and a cast to the input dtype after every conv.

Layout: the TPU kernel returns channel-major (B, H0, C, W0P) with a
4-column halo, a Mosaic constraint of its consumer
head_tail_ext_pallas(channel_major_halo=True). The port returns NHWC (B, H0,
W0, C), which ops/head_tail.head_tail_ext reads as it is, so it needs no
``channel_major_halo`` argument.

The kernel chain (csrc/rcu_pair.cu) is four 3x3 convs on the TMA + wgmma
GEMM core, each a call of :func:`rcu_conv` with its bf16 output in device
memory, each call counted once; each can be held alone against
:func:`rcu_conv_plain`. The GEMM core reads its input through TMA, which
cannot apply the ReLU on the way in, and the ReLU of a bf16 value is exact,
so the chain makes each conv's input ReLU beforehand: conv1a's call runs a
ReLU pass over rn0 first, and conv2a writes relu(t) beside t for conv1b
(``relu_copy``, ``relu_done``; the plain version takes the same arguments
and refuses ``relu_done`` on a negative input, and its chain equals the
four plain convs bit for bit).

Widths: the JAX kernel takes any C (``rcu_pick_block_rows`` only says
whether its row block fits the TPU's VMEM, None at vitl's C = 256 and
vitg's 384, where the JAX package keeps XLA's convs) and asserts only its
row block, so it refuses H0 < 4 (:func:`check_rows`; ValueError here, on
the CPU and on the card alike). On the card every C runs at Cp =
:func:`rcu_width` (C zero-padded up to the kernels' channel slices), the
weights padded once per weight (:func:`_rcu_weights`, kept by
``_prepared``), rn0 and path2 padded once by :func:`refinenet_pre`, the
output a view of its first C channels. Zero weights and biases keep the
padded channels exact zeros through the ReLUs and the residuals, so the
head's own channels get the sums of an unpadded run. The published widths
64, 128, 256 (vitl) and 384 (vitg) run unpadded.

At f32 (every width) each call runs ``vrvg_rcu_conv_f32``
(csrc/rcu_pair_f32.cu, counted as ``rcu_pair_f32``): the conv an implicit
GEMM on the 3xTF32 wgmma core (csrc/tf32x3_gemm.cuh), its weights split
once into TF32 hi/lo planes (:func:`_rcu_weights`), the bias, the ReLU, the
residuals and the ReLU'd copy in its epilogue, the ReLU pass on the input
as at bf16. The plain version sums in f64 for f64 operands (the f32 checks'
exact reference), in f32 otherwise.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from vr_video_generator_tpu_torch.kernels import counter, on_cuda, stream_handle
from vr_video_generator_tpu_torch.ops.head_tail import (_conv_split,
                                                         _prepared,
                                                         conv3x3_gemm_weights,
                                                         pad_to, sum_dtype)

LAUNCHES = counter("rcu_pair")
F32_LAUNCHES = counter("rcu_pair_f32")
MIN_ROWS = 4  # refinenet_pre_pallas: r = min(32, H0 - H0 % 4) > 0


def rcu_width(c: int, dtype: torch.dtype) -> int:
    """Cp: the width the chain runs C channels at on the card, C zero-padded
    up to its kernels' channel slices: at f32 a multiple of 32 (the 3xTF32
    conv's K slice, csrc/rcu_pair_f32.cu), otherwise of 64 (the bf16 core's
    K slice, csrc/rcu_pair.cu)."""
    step = 32 if dtype == torch.float32 else 64
    return -(-c // step) * step


def check_rows(h0: int) -> None:
    """Raise ValueError where refinenet_pre_pallas asserts: its row block r =
    min(block_rows, H0 - H0 % 4) must be a positive multiple of 4, so H0 >=
    4."""
    if h0 < MIN_ROWS:
        raise ValueError(f"the RCU pair takes H0 >= {MIN_ROWS} rows, got "
                         f"H0={h0}: refinenet_pre_pallas asserts r % 4 == 0 "
                         f"and r > 0 for r = min(block_rows, H0 - H0 % 4)")


def rcu_conv_plain(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor,
                   relu: bool, residuals: Sequence[torch.Tensor] = (),
                   relu_done: bool = False, relu_copy: bool = False):
    """One conv of the chain, (B, H0, W0, C) -> (B, H0, W0, C) in x's dtype:
    the f32 bias + the 3x3 conv (weights (C, C, 3, 3) cast to x's dtype,
    zero padding) of x, with ``relu`` a ReLU on x and on the f32 result,
    then the residuals added in f32 in order, one cast (f64 throughout for
    f64 x). ``relu_done`` says x is relu'd already: x is read as it is, as
    the kernel reads it, and a negative value in x raises; with
    ``relu_copy`` it returns (out, relu(out)). x (and the residuals) may
    carry channels past the weights' C, zeros (the chain's padded layout):
    the weights and bias are read as zeros there."""
    if relu_done and bool((x < 0).any()):
        raise ValueError("rcu_conv: relu_done with a negative value in x")
    cx = x.shape[-1]
    k, b = pad_to(k, cx, cx), pad_to(b, cx)
    dt = x.dtype
    acc = sum_dtype(dt)
    xin = x.permute(0, 3, 1, 2).to(acc)
    if relu and not relu_done:
        xin = F.relu(xin)
    y = b.to(acc)[:, None, None] + F.conv2d(xin, k.to(dt).to(acc), padding=1)
    if relu:
        y = F.relu(y)
    for r in residuals:
        y = y + r.permute(0, 3, 1, 2).to(acc)
    out = y.to(dt).permute(0, 2, 3, 1).contiguous()
    return (out, F.relu(out)) if relu_copy else out


def rcu_conv(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor, relu: bool,
             residuals: Sequence[torch.Tensor] = (), relu_done: bool = False,
             relu_copy: bool = False):
    """One conv of the chain (:func:`rcu_conv_plain`'s arguments): the plain
    version for CPU tensors, the CUDA kernel (csrc/rcu_pair.cu) for CUDA
    tensors (bf16 or f32, any C; the chain's three kinds: ReLU without
    residuals, or two or one residuals without ReLU; f32 tensors run the
    f32 kernel). With ``relu`` and not
    ``relu_done`` the call runs a ReLU pass over x first; with
    ``relu_done`` the kernel reads x as it is, which must then be relu'd
    already (the previous conv's ``relu_copy``): the plain version raises
    on a negative value, the kernel does not look. The kernel runs at Cp =
    :func:`rcu_width`: x with C channels is zero-padded to Cp for the call
    (its outputs views of their first C channels), x already at Cp (the
    chain's padded layout) is read as it is."""
    if not on_cuda(x, k, b, *residuals):
        return rcu_conv_plain(x, k, b, relu, residuals, relu_done, relu_copy)
    n, h0, w0, c = x.shape
    cp = rcu_width(k.shape[0], x.dtype)
    if c == k.shape[0] != cp:
        def pad(t):
            return F.pad(t, (0, cp - c))

        got = rcu_conv(pad(x), k, b, relu, [pad(r) for r in residuals],
                       relu_done, relu_copy)
        return tuple(t[..., :c] for t in got) if relu_copy else got[..., :c]
    if (bool(relu), len(residuals)) not in ((True, 0), (False, 1), (False, 2)):
        raise ValueError(f"rcu_conv takes ReLU without residuals or 1-2 "
                         f"residuals without ReLU, got relu={relu}, "
                         f"{len(residuals)} residuals")
    if relu and relu_copy or relu_done and not relu:
        raise ValueError("rcu_conv: relu_copy goes with a conv without ReLU, "
                         "relu_done with one with ReLU")
    if c != cp or tuple(k.shape) != (k.shape[0],) * 2 + (3, 3):
        raise ValueError(f"rcu_conv takes (C, C, 3, 3) weights and x of C or "
                         f"{cp} channels, got {tuple(k.shape)} and "
                         f"{tuple(x.shape)}")
    dt = x.dtype
    for t in (x, *residuals):
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != dt \
                or t.shape != x.shape:
            raise ValueError(f"rcu_conv takes bf16 or f32 {tuple(x.shape)} "
                             f"tensors of one dtype, got {t.dtype} "
                             f"{tuple(t.shape)}")
    from vr_video_generator_tpu_torch.kernels.build import check, library

    f32 = dt == torch.float32
    xs = x.contiguous()  # the kernel's channel rows
    res = [r.contiguous() for r in residuals]
    wt, bias = _prepared(_rcu_weights, (k, b), dt)
    out = torch.empty_like(xs)
    in_relu = torch.empty_like(xs) if relu and not relu_done else None
    out_relu = torch.empty_like(xs) if relu_copy else None
    ptrs = [r.data_ptr() for r in res] + [None] * (2 - len(res))
    kernel = "vrvg_rcu_conv_f32" if f32 else "vrvg_rcu_conv"
    err = getattr(library(), kernel)(
        xs.data_ptr(), None if in_relu is None else in_relu.data_ptr(),
        wt.data_ptr(), bias.data_ptr(), *ptrs, out.data_ptr(),
        None if out_relu is None else out_relu.data_ptr(), n, h0, w0, c,
        int(bool(relu)), len(res), stream_handle(x.device))
    check(err, kernel)
    (F32_LAUNCHES if f32 else LAUNCHES).count += 1
    return (out, out_relu) if relu_copy else out


def _rcu_weights(k: torch.Tensor, b: torch.Tensor,
                 dt: torch.dtype = torch.bfloat16):
    """A conv's weights as the GEMM core's B and its bias as an f32 vector,
    both zero-padded to Cp = :func:`rcu_width`: for bf16 the (Cp, 9 Cp) bf16
    GEMM weights; for f32 their TF32 split for the 3xTF32 core
    (ops/head_tail._conv_split: (2, 128 ceil(Cp / 128), 9 Cp)). Kept by
    ``_prepared``, so each weight is padded and split once."""
    cp = rcu_width(k.shape[0], dt)
    k = pad_to(k, cp, cp)
    w = _conv_split(k) if dt == torch.float32 else conv3x3_gemm_weights(k, dt)
    return w, pad_to(b.to(torch.float32, copy=True), cp)


def rcu_chain(conv: Callable, rn0: torch.Tensor, path2: torch.Tensor,
              k1a, b1a, k2a, b2a, k1b, b1b, k2b, b2b) -> torch.Tensor:
    """rcu2(path2 + rcu1(rn0)) as four calls of ``conv`` (rcu_conv or
    rcu_conv_plain), in the TPU kernel's order (:115-121); conv2a hands
    relu(t) to conv1b. H0 < 4 raises ValueError (:func:`check_rows`)."""
    check_rows(rn0.shape[1])
    rb = conv(rn0, k1a, b1a, True)
    t, t_relu = conv(rb, k2a, b2a, False, (rn0, path2), relu_copy=True)
    rd = conv(t_relu, k1b, b1b, True, relu_done=True)
    return conv(rd, k2b, b2b, False, (t,))


def refinenet_pre_plain(rn0: torch.Tensor, path2: torch.Tensor,
                        k1a: torch.Tensor, b1a: torch.Tensor,
                        k2a: torch.Tensor, b2a: torch.Tensor,
                        k1b: torch.Tensor, b1b: torch.Tensor,
                        k2b: torch.Tensor, b2b: torch.Tensor) -> torch.Tensor:
    """rn0, path2 (B, H0, W0, C) -> rcu2(path2 + rcu1(rn0)) (B, H0, W0, C) in
    their dtype. Weights in PyTorch layout (C, C, 3, 3), cast to the input
    dtype; biases (C,), used in f32."""
    return rcu_chain(rcu_conv_plain, rn0, path2, k1a, b1a, k2a, b2a, k1b, b1b,
                     k2b, b2b)


def refinenet_pre(rn0: torch.Tensor, path2: torch.Tensor, k1a: torch.Tensor,
                  b1a: torch.Tensor, k2a: torch.Tensor, b2a: torch.Tensor,
                  k1b: torch.Tensor, b1b: torch.Tensor, k2b: torch.Tensor,
                  b2b: torch.Tensor) -> torch.Tensor:
    """rn0, path2 (B, H0, W0, C), any strides -> (B, H0, W0, C): the plain
    version for CPU tensors, four calls of the conv kernel (conv1a's after
    its ReLU pass) for CUDA tensors (bf16 or f32, any C, H0 >= 4): rn0 and
    path2 zero-padded once to Cp = :func:`rcu_width`, the output a view of
    the first C channels of the chain's."""
    ws = (k1a, b1a, k2a, b2a, k1b, b1b, k2b, b2b)
    if not on_cuda(rn0, path2, *ws):
        return refinenet_pre_plain(rn0, path2, *ws)
    c = rn0.shape[-1]
    cp = rcu_width(c, rn0.dtype)
    # Copied once, padded or strided: each is read by two calls.
    rn0, path2 = (F.pad(t, (0, cp - c)) if cp != c else t.contiguous()
                  for t in (rn0, path2))
    return rcu_chain(rcu_conv, rn0, path2, *ws)[..., :c]
