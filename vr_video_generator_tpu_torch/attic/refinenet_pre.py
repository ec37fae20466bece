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
``rcu_pick_block_rows`` (whether the TPU kernel's row block fits VMEM; None
at vitl's C = 256) becomes :func:`takes`: the widths the CUDA kernel is
built for, C in {64, 128} (vits, vitb). On the card another width raises
NotImplementedError naming the roadmap item.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from vr_video_generator_tpu_torch import not_ported
from vr_video_generator_tpu_torch.kernels import counter, on_cuda, stream_handle
from vr_video_generator_tpu_torch.ops.head_tail import (_prepared,
                                                         conv3x3_gemm_weights)

LAUNCHES = counter("rcu_pair")
CHANNELS = (64, 128)  # the feature widths csrc/rcu_pair.cu takes


def takes(features: int) -> bool:
    """Whether the RCU-pair kernels are built for ``features`` channels."""
    return features in CHANNELS


def rcu_conv_plain(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor,
                   relu: bool, residuals: Sequence[torch.Tensor] = (),
                   relu_done: bool = False, relu_copy: bool = False):
    """One conv of the chain, (B, H0, W0, C) -> (B, H0, W0, C) in x's dtype:
    the f32 bias + the 3x3 conv (weights (C, C, 3, 3) cast to x's dtype,
    zero padding) of x, with ``relu`` a ReLU on x and on the f32 result,
    then the residuals added in f32 in order, one cast. ``relu_done`` says
    x is relu'd already: x is read as it is, as the kernel reads it, and a
    negative value in x raises; with ``relu_copy`` it returns (out,
    relu(out))."""
    if relu_done and bool((x < 0).any()):
        raise ValueError("rcu_conv: relu_done with a negative value in x")
    dt = x.dtype
    xin = x.permute(0, 3, 1, 2).float()
    if relu and not relu_done:
        xin = F.relu(xin)
    y = b.float()[:, None, None] + F.conv2d(xin, k.to(dt).float(), padding=1)
    if relu:
        y = F.relu(y)
    for r in residuals:
        y = y + r.permute(0, 3, 1, 2).float()
    out = y.to(dt).permute(0, 2, 3, 1).contiguous()
    return (out, F.relu(out)) if relu_copy else out


def rcu_conv(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor, relu: bool,
             residuals: Sequence[torch.Tensor] = (), relu_done: bool = False,
             relu_copy: bool = False):
    """One conv of the chain (:func:`rcu_conv_plain`'s arguments): the plain
    version for CPU tensors, the CUDA kernel (csrc/rcu_pair.cu) for CUDA
    tensors (bf16, C in ``CHANNELS``; the chain's three kinds: ReLU without
    residuals, or two or one residuals without ReLU). With ``relu`` and not
    ``relu_done`` the call runs a ReLU pass over x first; with
    ``relu_done`` the kernel reads x as it is, which must then be relu'd
    already (the previous conv's ``relu_copy``): the plain version raises
    on a negative value, the kernel does not look."""
    if not on_cuda(x, k, b, *residuals):
        return rcu_conv_plain(x, k, b, relu, residuals, relu_done, relu_copy)
    n, h0, w0, c = x.shape
    if not takes(c):
        not_ported(f"the fused refinenet1 RCU pair at C={c} on the card",
                   "DPT tail kernels at other widths")
    if (bool(relu), len(residuals)) not in ((True, 0), (False, 1), (False, 2)):
        raise ValueError(f"rcu_conv takes ReLU without residuals or 1-2 "
                         f"residuals without ReLU, got relu={relu}, "
                         f"{len(residuals)} residuals")
    if relu and relu_copy or relu_done and not relu:
        raise ValueError("rcu_conv: relu_copy goes with a conv without ReLU, "
                         "relu_done with one with ReLU")
    if tuple(k.shape) != (c, c, 3, 3):
        raise ValueError(f"rcu_conv weights must be {(c, c, 3, 3)}, got "
                         f"{tuple(k.shape)}")
    for t in (x, *residuals):
        if t.dtype != torch.bfloat16 or t.shape != x.shape:
            raise ValueError(f"rcu_conv takes bf16 {tuple(x.shape)} tensors, "
                             f"got {t.dtype} {tuple(t.shape)}")
    from vr_video_generator_tpu_torch.kernels.build import check, library

    xs = x.contiguous()  # the TMA boxes' channel rows
    res = [r.contiguous() for r in residuals]
    wt, bias = _prepared(_rcu_weights, (k, b))
    out = torch.empty_like(xs)
    in_relu = torch.empty_like(xs) if relu and not relu_done else None
    out_relu = torch.empty_like(xs) if relu_copy else None
    ptrs = [r.data_ptr() for r in res] + [None] * (2 - len(res))
    err = library().vrvg_rcu_conv(
        xs.data_ptr(), None if in_relu is None else in_relu.data_ptr(),
        wt.data_ptr(), bias.data_ptr(), *ptrs, out.data_ptr(),
        None if out_relu is None else out_relu.data_ptr(), n, h0, w0, c,
        int(bool(relu)), len(res), stream_handle(x.device))
    check(err, "vrvg_rcu_conv")
    LAUNCHES.count += 1
    return (out, out_relu) if relu_copy else out


def _rcu_weights(k: torch.Tensor, b: torch.Tensor):
    """A conv's weights as the GEMM core's B (C, 9 C) bf16 and its bias as
    an f32 vector."""
    return conv3x3_gemm_weights(k), b.to(torch.float32, copy=True)


def rcu_chain(conv: Callable, rn0: torch.Tensor, path2: torch.Tensor,
              k1a, b1a, k2a, b2a, k1b, b1b, k2b, b2b) -> torch.Tensor:
    """rcu2(path2 + rcu1(rn0)) as four calls of ``conv`` (rcu_conv or
    rcu_conv_plain), in the TPU kernel's order (:115-121); conv2a hands
    relu(t) to conv1b."""
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
    its ReLU pass) for CUDA tensors (bf16, C in ``CHANNELS``)."""
    # Copied once if strided: each is read by two calls.
    return rcu_chain(rcu_conv, rn0.contiguous(), path2.contiguous(), k1a, b1a,
                     k2a, b2a, k1b, b1b, k2b, b2b)
