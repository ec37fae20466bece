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

The kernel is one 3x3 conv (csrc/rcu_pair.cu), launched four times by
:func:`rcu_chain` with bf16 intermediates in device memory, each launch
counted; each conv can be held alone against :func:`rcu_conv_plain`.
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

LAUNCHES = counter("rcu_pair")
CHANNELS = (64, 128)  # the feature widths csrc/rcu_pair.cu takes


def takes(features: int) -> bool:
    """Whether the RCU-pair kernels are built for ``features`` channels."""
    return features in CHANNELS


def rcu_conv_plain(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor,
                   relu: bool, residuals: Sequence[torch.Tensor] = ()
                   ) -> torch.Tensor:
    """One conv of the chain, (B, H0, W0, C) -> (B, H0, W0, C) in x's dtype:
    the f32 bias + the 3x3 conv (weights (C, C, 3, 3) cast to x's dtype,
    zero padding) of x, with ``relu`` a ReLU on x and on the f32 result,
    then the residuals added in f32 in order, one cast."""
    dt = x.dtype
    xin = x.permute(0, 3, 1, 2).float()
    if relu:
        xin = F.relu(xin)
    y = b.float()[:, None, None] + F.conv2d(xin, k.to(dt).float(), padding=1)
    if relu:
        y = F.relu(y)
    for r in residuals:
        y = y + r.permute(0, 3, 1, 2).float()
    return y.to(dt).permute(0, 2, 3, 1).contiguous()


def rcu_conv(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor, relu: bool,
             residuals: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """One conv of the chain: the plain version for CPU tensors, the CUDA
    kernel (csrc/rcu_pair.cu) for CUDA tensors (bf16, C in ``CHANNELS``;
    the chain's three kinds: ReLU without residual, or two or one residual
    without ReLU)."""
    if not on_cuda(x, k, b, *residuals):
        return rcu_conv_plain(x, k, b, relu, residuals)
    n, h0, w0, c = x.shape
    if not takes(c):
        not_ported(f"the fused refinenet1 RCU pair at C={c} on the card",
                   "DPT tail kernels at other widths")
    if (bool(relu), len(residuals)) not in ((True, 0), (False, 1), (False, 2)):
        raise ValueError(f"rcu_conv takes ReLU without residuals or 1-2 "
                         f"residuals without ReLU, got relu={relu}, "
                         f"{len(residuals)} residuals")
    if tuple(k.shape) != (c, c, 3, 3):
        raise ValueError(f"rcu_conv weights must be {(c, c, 3, 3)}, got "
                         f"{tuple(k.shape)}")
    for t in (x, *residuals):
        if t.dtype != torch.bfloat16 or t.shape != x.shape:
            raise ValueError(f"rcu_conv takes bf16 {tuple(x.shape)} tensors, "
                             f"got {t.dtype} {tuple(t.shape)}")
    from vr_video_generator_tpu_torch.kernels.build import check, library

    xs = x.contiguous()  # channel rows of 16-byte loads
    res = [r.contiguous() for r in residuals]
    wt = k.to(torch.bfloat16).permute(2, 3, 1, 0).contiguous()  # (3, 3, I, O)
    bias = b.to(torch.float32).contiguous()
    out = torch.empty_like(xs)
    ptrs = [r.data_ptr() for r in res] + [None] * (2 - len(res))
    err = library().vrvg_rcu_conv(
        xs.data_ptr(), wt.data_ptr(), bias.data_ptr(), *ptrs, out.data_ptr(),
        n, h0, w0, c, int(bool(relu)), len(res), stream_handle(x.device))
    check(err, "vrvg_rcu_conv")
    LAUNCHES.count += 1
    return out


def rcu_chain(conv: Callable, rn0: torch.Tensor, path2: torch.Tensor,
              k1a, b1a, k2a, b2a, k1b, b1b, k2b, b2b) -> torch.Tensor:
    """rcu2(path2 + rcu1(rn0)) as four calls of ``conv`` (rcu_conv or
    rcu_conv_plain), in the TPU kernel's order (:115-121)."""
    rb = conv(rn0, k1a, b1a, True)
    t = conv(rb, k2a, b2a, False, (rn0, path2))
    rd = conv(t, k1b, b1b, True)
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
    version for CPU tensors, four launches of the conv kernel for CUDA
    tensors (bf16, C in ``CHANNELS``)."""
    return rcu_chain(rcu_conv, rn0, path2, k1a, b1a, k2a, b2a, k1b, b1b, k2b,
                     b2b)
