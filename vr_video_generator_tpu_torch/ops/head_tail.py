"""The DPT head's tail from refinenet1's pre-upsample activation to depth: the
CUDA kernels, their plain versions, and the JAX package's choice between them;
and the older single-kernel tail from path1.

Two tails, as in vr_video_generator_tpu/ops/head_tail_pallas.py, picked by
its planners (:func:`plan_tail`: ``ext_pick_block_rows``, then
``big_pick_plan``, copied here as pure integer arithmetic).

The ext tail replaces `head_tail_ext_pallas` (body `_tail_ext_kernel`, row 7):

    bilinear x2 (align corners) -> out_conv 1x1 -> output_conv1 3x3 ->
    bilinear to out_hw -> output_conv2 3x3 -> ReLU -> 1x1 -> ReLU

in the TPU kernel's order and at its rounding points: the out_conv channel
mix before the resizes (a 1x1 commutes with them), the W-resizes as GEMMs
with bf16 weights, the H-resizes as exact integer taps with an f32 lerp
(the out_conv bias added there, zero outside the image), conv1's f32 bias
added before its cast, conv2's f32 bias and ReLU, and the 1x1 in f32. On
the card it runs as five stages, each with its own plain version (the whole
plain version composes them): the out_conv mix (xoc), the upsample pass
with the out_conv bias (Z), conv1 with its f32 bias before the cast (c1),
the resize pass (R) and conv2 with the 1x1; the first three are the entry
point ``vrvg_head_tail_ext_front`` and the last two the big-C tail's back
without ``cw``, all in ``csrc/head_tail_big.cu`` (see its header). A head
of 32 features (a custom config) runs the older chain of
``csrc/head_tail.cu`` instead, chosen by width, which holds a whole input
row in shared memory. At f32 (``--compute_dtype float32``, C = 64 to 384)
the same five stages run as one entry point, ``vrvg_head_tail_ext_f32``
(counted as ``head_tail_ext_f32``): the passes instantiated on f32, the mix
(the dense product) and both convs (implicit GEMMs, conv2 with the 1x1) on
the 3xTF32 wgmma core (csrc/tf32x3_gemm.cuh), their three weights split
once into TF32 hi/lo planes (:func:`_ext_f32_weights`), the W-resize
weights f32 as the plain version's are at f32.

The single-kernel tail replaces `head_tail_pallas` (body `_tail_kernel`, row
15), which no CLI path of the JAX package runs (its DPT head takes the ext or
the big-C tail): path1 (B, H2, W2, C) -> output_conv1 3x3 (its f32 sum, then
+ b1, then the cast) -> the W-resize with bf16 weights -> the H-resize (exact
taps, f32 lerp) -> output_conv2 3x3 + b2, ReLU -> the f32 1x1 + b3, ReLU. Its
back half is the ext tail's from conv1's output on, so on the card it runs
as three stages with their own plain versions: conv1 with its f32 bias
before the cast (c1; the halo kernel at C = 64, the GEMM core at C = 128),
the resize pass (R) and conv2 with the 1x1, all one entry point
(``vrvg_head_tail`` in csrc/head_tail_big.cu, after an NCHW path1's
transpose). At C = 32 it runs csrc/head_tail.cu's wmma chain, chosen by
width there (``BASE_CONV1``). At f32 (C = 64 and 128) the same three stages
run as the entry point ``vrvg_head_tail_f32`` (counted as
``head_tail_f32``): conv1 with its f32 bias and conv2 with the 1x1 on the
3xTF32 wgmma core (row 7's f32 convs), their weights split once into TF32
hi/lo planes (:func:`_base_f32_weights`), the resize pass on f32, the
W-resize weights f32.

The big-C tail (vitl, vitg) replaces `head_tail_big_pallas`, front (body
`_big_front_kernel`, row 11) and back (`_big_back_kernel`, row 12), at its
own rounding points, which are not the ext tail's: x is W- and H-upsampled
first (bf16 after each), out_conv's 1x1 mix is folded into conv1's weights in
f32 and cast, conv1's f32 sum is cast to bf16 before the W-resize, and
out_conv's bias and conv1's bias ride ``cw``, conv1's response to the bias
image per row case (interior, top, bottom), W-resized in f32 and added before
the intermediate's cast. The back H-resizes (f32 lerp, bf16), runs conv2 with
its f32 bias, ReLU, the f32 1x1 and ReLU. The kernels are
``csrc/head_tail_big.cu``, a short chain for each wrapper: the front
transposes an NCHW x to NHWC, then runs the upsample pass (U, the upsampled
conv1 input) and conv1 as an implicit GEMM on the TMA + wgmma core; their
intermediate is the bf16 post-conv1 product (B, 2 H0, 2 W0, C/2); the back
runs the resize pass (R: the W-resize and ``cw``, then the H-resize) and
conv2 with the 1x1 in registers. Each of those four stages has its own
plain version, and the whole plain versions compose them. At f32 (C = 64 to
384) front and back run as one entry point, ``vrvg_head_tail_big_f32``
(counted as ``head_tail_big_f32``): the passes instantiated on f32, conv1
(out_conv's mix folded in f32, as the JAX front folds it) and conv2 with
the 1x1 as implicit GEMMs on the 3xTF32 wgmma core (csrc/tf32x3_gemm.cuh),
their weights split once into TF32 hi/lo planes (:func:`_big_f32_weights`),
``cw`` and the resize weights f32. ``conv3x3_f32`` exposes that core's conv
sums alone (no CLI path calls it), for a check of conv2 before its 1x1.
"""

from __future__ import annotations

import functools
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vr_video_generator_tpu_torch import not_ported
from vr_video_generator_tpu_torch.kernels import counter, on_cuda, stream_handle
from vr_video_generator_tpu_torch.ops.mlp import tf32x3_split_kernel
from vr_video_generator_tpu_torch.ops.resize import linear_weights

LAUNCHES = counter("head_tail_ext")
F32_LAUNCHES = counter("head_tail_ext_f32")
BASE_LAUNCHES = counter("head_tail")
BIG_FRONT_LAUNCHES = counter("head_tail_big_front")
BIG_BACK_LAUNCHES = counter("head_tail_big_back")
BIG_F32_LAUNCHES = counter("head_tail_big_f32")
CONV3X3_F32_LAUNCHES = counter("conv3x3_f32")
BASE_F32_LAUNCHES = counter("head_tail_f32")
CHANNELS = (32, 64, 128, 256, 384)  # the feature widths head_tail_ext takes
EXT_CHANNELS = CHANNELS[1:]         # ... through vrvg_head_tail_ext_front
BIG_CHANNELS = (64, 128, 256, 384)  # the feature widths csrc/head_tail_big.cu takes
# ... at f32, by both vrvg_head_tail_ext_f32 and vrvg_head_tail_big_f32
EXT_F32_CHANNELS = BIG_CHANNELS
BASE_CHANNELS = (32, 64, 128)       # path1 widths the single-kernel tail takes
BASE_F32_CHANNELS = (64, 128)       # ... at f32 (vrvg_head_tail_f32)
CONV3X3_F32_OUT = (32, 64, 128, 192)  # the output widths vrvg_conv3x3_f32 takes
# The kernel vrvg_head_tail runs conv1 on at each path1 width, and so the
# layout of its weights: csrc/head_tail.cu's wmma chain, row 12's halo-tile
# kernel (Conv1Out), or the GEMM core (256 x 64 tiles).
BASE_CONV1 = {32: "wmma", 64: "halo", 128: "core"}
C3 = 32                             # output_conv2's width in the reference head
SMEM_PER_BLOCK = 232448             # shared memory one block may have (H100)


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def ext_mix_smem(w0: int, c: int) -> int:
    """Shared memory of the C = 32 ext chain's first kernel (``mix_smem`` in
    csrc/head_tail.cu), which holds a whole input row of W0 pixels."""
    w0p, nc = -(-w0 // 16) * 16, min(c, 64)
    return (_align128(w0p * (c + 16) * 2) + _align128(nc * (c + 16) * 2)
            + _align128(w0p * nc * 2) + 4 * 256 * 4)


def takes(features: int, w0: int) -> bool:
    """Whether the ext kernels are built for a head of ``features`` channels
    on a grid W0 pixels wide: any grid at ``EXT_CHANNELS``; at C = 32 one
    whose row fits the older chain's first kernel."""
    return features in EXT_CHANNELS or (
        features in CHANNELS and ext_mix_smem(w0, features) <= SMEM_PER_BLOCK)


def takes_f32(features: int) -> bool:
    """Whether the f32 tail kernels, ext and big-C, are built for a head of
    ``features`` channels (any grid)."""
    return features in EXT_F32_CHANNELS


def base_takes(features: int) -> bool:
    """Whether the single-kernel tail is built for path1 of ``features``
    channels (vits and vitb: C2 = C / 2, C3 = 32)."""
    return features in BASE_CHANNELS


def big_takes(features: int) -> bool:
    """Whether the big-C kernels are built for ``features`` channels."""
    return features in BIG_CHANNELS


# --- the JAX package's tail planners (head_tail_pallas.py:45, 223-251,
# 613-660): which tail fits the TPU's VMEM at a geometry. The port runs the
# tail they pick, so both packages compute the same function everywhere.

def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def _lane(n: int) -> int:
    return n + (-n) % 128


def c3_est(c2: int) -> int:
    """conv2 output width used for planning (reference head: always 32)."""
    return min(32, c2)


def _ext_plan(r, h0, hm, h1, w0, w2, w1, c, c2, isz):
    span1 = int(np.ceil((r + 1) * (hm - 1) / (h1 - 1))) + 3
    a1 = min(_pad4(span1), hm - hm % 4)
    span0 = int(np.ceil((a1 + 1) * (h0 - 1) / (hm - 1))) + 3
    a0 = min(_pad4(span0), h0 - h0 % 4)
    if a1 < span1 or a0 < span0:
        return None
    est = isz * (a0 * c * _lane(w0 + (-w0) % 128) + a0 * c * _lane(w2)
                 + (a1 + 2) * c * _lane(w2 + 2) + a1 * c2 * _lane(w2)
                 + a1 * c2 * _lane(w1) + (r + 2) * c2 * _lane(w1 + 2))
    est += 2 * 4 * r * _lane(w1)
    return (a0, a1, est)


def ext_pick_block_rows(x_shape, c2: int, dtype: torch.dtype,
                        out_hw) -> Optional[int]:
    """The ext tail's row block, or None where it does not fit."""
    _, h0, w0, c = x_shape
    h1, w1 = out_hw
    for cand in (32, 24, 16, 8):
        p = _ext_plan(cand, h0, h0 * 2, h1, w0, w0 * 2, w1, c, c2,
                      dtype.itemsize)
        if p and p[2] <= 10.5 * 2 ** 20:
            return cand
    return None


def big_pick_plan(x_shape, c2: int, dtype: torch.dtype, out_hw):
    """The big-C tail's (RM, A0, R, A) row plan, or None where it does not
    fit."""
    _, h0, w0, c = x_shape
    hm, w2 = 2 * h0, 2 * w0
    h1, w1 = out_hw
    isz = dtype.itemsize
    w0p, w2p2, w1p = _lane(w0), _lane(w2 + 2), _lane(w1 + 2)
    front = None
    cpr = c if c <= 128 else 128
    for rm in (16, 8, 4):
        a0 = _pad4(int(np.ceil((rm + 1) * (h0 - 1) / (hm - 1))) + 3)
        if a0 > h0 - h0 % 4:
            continue
        est = isz * (a0 * cpr * (w0p + w2) + (rm + 2) * c * w2p2
                     + 2 * rm * c2 * w1p
                     + w0p * w2 + 9 * c2 * c + w2p2 * w1p)
        est += 4 * c2 * w2p2 + 4 * 3 * c2 * w1p
        if est <= 14 * 2 ** 20:
            front = (rm, a0)
            break
    if front is None:
        return None
    back = None
    for r in (32, 24, 16, 8):
        a = _pad4(int(np.ceil((r + 1) * (hm - 1) / (h1 - 1))) + 3)
        if a > hm - hm % 4:
            continue
        est = isz * (a * c2 * w1p + (r + 2) * c2 * w1p
                     + 3 * 4 * c3_est(c2) * 6 * c2)
        est += 2 * 4 * r * w1p
        if est <= 12.5 * 2 ** 20:
            back = (r, a)
            break
    if back is None:
        return None
    return (*front, *back)


def plan_tail(x_shape, dtype: torch.dtype, out_hw) -> Optional[str]:
    """The fused tail the JAX package runs for refinenet1's pre-upsample
    shape (B, H0, W0, C) in ``dtype`` (its models/dpt.py DPTHead): "ext" if
    the ext plan fits, else "big" if the big-C plan fits, else None (the
    unfused tail)."""
    c2 = x_shape[-1] // 2
    if ext_pick_block_rows(x_shape, c2, dtype, out_hw) is not None:
        return "ext"
    if big_pick_plan(x_shape, c2, dtype, out_hw) is not None:
        return "big"
    return None


def lerp_taps(n_in: int, n_out: int) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """Exact align-corners taps of an n_in -> n_out resize
    (head_tail_pallas._lerp_taps): rows i0, i1 and the f32 fraction t."""
    r = torch.arange(n_out, dtype=torch.int64)
    if n_out == 1:
        zero = torch.zeros(1, dtype=torch.int64)
        return zero, zero, torch.zeros(1)
    num = r * (n_in - 1)
    i0 = num // (n_out - 1)
    t = (num - i0 * (n_out - 1)).float() / float(n_out - 1)
    return i0, torch.clamp(i0 + 1, max=n_in - 1), t


def _hlerp(x: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    """(1 - t) * x[i0] + t * x[i1] along ``axis`` of an f32 tensor."""
    i0, i1, t = lerp_taps(x.shape[axis], n_out)
    shape = [1] * x.ndim
    shape[axis] = n_out
    t = t.to(x.device).reshape(shape)
    a = x.index_select(axis, i0.to(x.device))
    b = x.index_select(axis, i1.to(x.device))
    return (1 - t) * a + t * b


def _resize_matrix(n_in: int, n_out: int, dt: torch.dtype,
                   device) -> torch.Tensor:
    """The (n_out, n_in) align-corners resize matrix rounded to ``dt``, as
    f32 (the TPU's resize GEMM operand)."""
    return torch.as_tensor(linear_weights(n_in, n_out, align_corners=True),
                           dtype=dt, device=device).float()


def sum_dtype(dt: torch.dtype) -> torch.dtype:
    """The dtype a plain product sums in: f32, or f64 for f64 operands (the
    f32 kernels' exact reference)."""
    return torch.float64 if dt == torch.float64 else torch.float32


def ext_mix_plain(x: torch.Tensor, k_oc: torch.Tensor) -> torch.Tensor:
    """Row 7's first stage: x (B, H0, W0, C) -> xoc (B, H0, W0, C) in x's
    dtype, the out_conv 1x1 mix (C out, C in, 1, 1) per pixel: f32 sums ->
    dtype."""
    dt, acc = x.dtype, sum_dtype(x.dtype)
    return (x.to(acc) @ k_oc[:, :, 0, 0].to(dt).to(acc).T).to(dt)


def ext_conv1_plain(z: torch.Tensor, k1: torch.Tensor,
                    b1: torch.Tensor) -> torch.Tensor:
    """Row 7's conv1: Z (B, HM, W2, C) -> c1 (B, HM, W2, C2) in Z's dtype:
    output_conv1 3x3 with zero padding, f32 sums + the f32 bias, then the
    cast."""
    dt, acc = z.dtype, sum_dtype(z.dtype)
    c1 = F.conv2d(z.permute(0, 3, 1, 2).to(acc), k1.to(dt).to(acc),
                  b1.to(acc), padding=1).to(dt)
    return c1.permute(0, 2, 3, 1)


def ext_resize_plain(c1: torch.Tensor,
                     out_hw: Tuple[int, int]) -> torch.Tensor:
    """Row 7's resize pass: c1 (B, HM, W2, C2) -> R (B, H1, W1, C2) in c1's
    dtype: the W-resize (bf16-rounded weights, f32 sums) -> dtype, the
    H-resize (f32 lerp) -> dtype (head_tail_pallas.py:123-141, :327-341)."""
    dt = c1.dtype
    h1, w1 = out_hw
    c = c1.permute(0, 3, 1, 2)
    wtb = _resize_matrix(c.shape[3], w1, dt, c.device)
    c1w = torch.einsum("bchw,vw->bchv", c.float(), wtb).to(dt)
    return _hlerp(c1w.float(), h1, 2).to(dt).permute(0, 2, 3, 1)


def head_tail_ext_plain(x: torch.Tensor, k_oc: torch.Tensor,
                        b_oc: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor,
                        k2: torch.Tensor, b2: torch.Tensor, k3: torch.Tensor,
                        b3: torch.Tensor, out_hw: Tuple[int, int]
                        ) -> torch.Tensor:
    """x (B, H0, W0, C) -> depth (B, H1, W1) f32: the row-7 stages composed
    (:func:`ext_mix_plain`, :func:`big_upsample_plain` with the out_conv
    bias, :func:`ext_conv1_plain`, :func:`ext_resize_plain`,
    :func:`big_conv2_plain`). Weights in PyTorch layout: k_oc (C, C, 1, 1),
    k1 (C2, C, 3, 3), k2 (C3, C2, 3, 3), k3 (1, C3, 1, 1); biases (out,)."""
    z = big_upsample_plain(ext_mix_plain(x, k_oc), b_oc)
    r = ext_resize_plain(ext_conv1_plain(z, k1, b1), out_hw)
    return big_conv2_plain(r, k2, b2, k3, b3)


def base_conv1_plain(path1: torch.Tensor, k1: torch.Tensor,
                     b1: torch.Tensor) -> torch.Tensor:
    """Row 15's conv1: path1 (B, H2, W2, C) -> c1 (B, H2, W2, C2) in
    path1's dtype: output_conv1 3x3 with zero padding, its f32 sum, then +
    the f32 bias, then the cast (head_tail_pallas.py:113-121)."""
    dt, f32 = path1.dtype, torch.float32
    c1 = F.conv2d(path1.permute(0, 3, 1, 2).float(), k1.to(dt).float(),
                  padding=1)
    return (c1 + b1.to(f32)[:, None, None]).to(dt).permute(0, 2, 3, 1)


def head_tail_plain(path1: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor,
                    k2: torch.Tensor, b2: torch.Tensor, k3: torch.Tensor,
                    b3: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """path1 (B, H2, W2, C) -> depth (B, H1, W1) f32, head_tail_pallas's
    function: :func:`base_conv1_plain`, then the ext tail's back half
    (:func:`ext_resize_plain`, :func:`big_conv2_plain`;
    head_tail_pallas.py:123-153). Weights in PyTorch layout: k1 (C2, C, 3,
    3), k2 (C3, C2, 3, 3), k3 (1, C3, 1, 1); biases (out,)."""
    r = ext_resize_plain(base_conv1_plain(path1, k1, b1), out_hw)
    return big_conv2_plain(r, k2, b2, k3, b3)


def _check_base(path1: torch.Tensor, k1, k2, k3) -> None:
    b, h2, w2, c = path1.shape
    c2 = c // 2
    if not base_takes(c):
        not_ported(f"the single-kernel DPT tail at C={c} on the card",
                   "DPT tail kernels at other widths")
    if path1.dtype == torch.float32:
        if c not in BASE_F32_CHANNELS:
            not_ported(f"the single-kernel DPT tail at f32 at C={c} on the "
                       f"card (vrvg_head_tail_f32 takes C in "
                       f"{BASE_F32_CHANNELS})", "f32 on the card")
    elif path1.dtype != torch.bfloat16:
        raise ValueError(f"head_tail kernel takes bf16 or f32 input, got "
                         f"{path1.dtype}")
    for name, t, shape in (("output_conv1", k1, (c2, c, 3, 3)),
                           ("output_conv2.0", k2, (C3, c2, 3, 3)),
                           ("output_conv2.2", k3, (1, C3, 1, 1))):
        if tuple(t.shape) != shape:
            raise ValueError(f"head_tail {name} weight must be {shape}, "
                             f"got {tuple(t.shape)}")


def _base_weights(k1, b1, k2, b2, k3, b3):
    """Row 15's weights as vrvg_head_tail reads them at path1's width
    (``BASE_CONV1``): conv1 and conv2 as (3, 3, in, out) for the wmma chain;
    otherwise conv1 as the halo kernel's rows or the GEMM's B and conv2 as
    the halo kernel's rows; then the f32 vectors b1, b2, the 1x1, b3."""
    kind = BASE_CONV1[k1.shape[1]]
    if kind == "wmma":
        w1, w2 = (k.to(torch.bfloat16).permute(2, 3, 1, 0).contiguous()
                  for k in (k1, k2))
    else:
        w1 = conv2_weights(k1) if kind == "halo" else conv3x3_gemm_weights(k1)
        w2 = conv2_weights(k2)
    return (w1, w2, *_f32_vectors(b1, b2, k3, b3))


def _base_f32_weights(k1, b1, k2, b2, k3, b3):
    """Row 15's weights as vrvg_head_tail_f32 reads them: conv1 and conv2
    split for the 3xTF32 core's conv (:func:`_conv_split`), and the f32
    vectors b1, b2, the 1x1, b3. Kept by :func:`_prepared`, so the first
    call on a set of weights splits them and later calls do not."""
    return (_conv_split(k1), _conv_split(k2), *_f32_vectors(b1, b2, k3, b3))


def _launch_base(path1: torch.Tensor, wts, out_hw):
    """One launch of vrvg_head_tail on path1 (B, H2, W2, C) bf16, or of
    vrvg_head_tail_f32 on f32 path1, with the torch weights ``wts`` (k1, b1,
    k2, b2, k3, b3): (c1, R, depth), R None at C = 32 (the wmma chain has no
    resize pass)."""
    from vr_video_generator_tpu_torch.kernels.build import check, library

    b, h2, w2, c = path1.shape
    h1, w1 = out_hw
    c2 = c // 2
    f32 = path1.dtype == torch.float32
    w1m, w2m, b1f, b2f, w3f, b3f = _prepared(
        _base_f32_weights if f32 else _base_weights, wts)
    if BASE_CONV1[c] == "wmma":
        x, nchw, xt = path1.contiguous(), False, path1
    else:
        x, nchw, xt = _channels_last(path1)
    taps, tapw = _device_taps(w2, w1, x.device, path1.dtype)
    new = functools.partial(torch.empty, dtype=path1.dtype, device=x.device)
    c1 = new((b, h2, w2, c2))
    r = new((b, h1, w1, c2)) if BASE_CONV1[c] != "wmma" else None
    out = torch.empty((b, h1, w1), dtype=torch.float32, device=x.device)
    kernel = "vrvg_head_tail_f32" if f32 else "vrvg_head_tail"
    check(getattr(library(), kernel)(
        x.data_ptr(), int(nchw), xt.data_ptr(), w1m.data_ptr(),
        b1f.data_ptr(), w2m.data_ptr(), b2f.data_ptr(), w3f.data_ptr(),
        b3f.data_ptr(), taps.data_ptr(), tapw.data_ptr(), c1.data_ptr(),
        None if r is None else r.data_ptr(), out.data_ptr(), b, h2, w2, c,
        h1, w1, stream_handle(x.device)), kernel)
    (BASE_F32_LAUNCHES if f32 else BASE_LAUNCHES).count += 1
    return c1, r, out


def head_tail(path1: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor,
              k2: torch.Tensor, b2: torch.Tensor, k3: torch.Tensor,
              b3: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """path1 (B, H2, W2, C), any strides -> depth (B, H1, W1) f32: the plain
    version for CPU tensors, the row-15 kernels for CUDA tensors (bf16, C in
    ``BASE_CHANNELS``, another width raising naming the roadmap item; f32,
    C in ``BASE_F32_CHANNELS``)."""
    args = (k1, b1, k2, b2, k3, b3)
    if not on_cuda(path1, *args):
        return head_tail_plain(path1, *args, out_hw)
    _check_base(path1, k1, k2, k3)
    return _launch_base(path1, args, out_hw)[-1]


def head_tail_stages(path1: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor,
                     k2: torch.Tensor, b2: torch.Tensor, k3: torch.Tensor,
                     b3: torch.Tensor, out_hw: Tuple[int, int]):
    """Row 15 stage by stage: (c1, R, depth), c1 (B, H2, W2, C2) and R (B,
    H1, W1, C2) channels-last, depth (B, H1, W1) f32. For CPU tensors, the
    plain versions of the stages (composed, :func:`head_tail_plain`); for
    CUDA tensors (bf16 or f32, C in 64 or 128), one launch of the chain,
    whose scratch holds the intermediates."""
    args = (k1, b1, k2, b2, k3, b3)
    if not on_cuda(path1, *args):
        c1 = base_conv1_plain(path1, k1, b1)
        r = ext_resize_plain(c1, out_hw)
        return c1, r, big_conv2_plain(r, k2, b2, k3, b3)
    _check_base(path1, k1, k2, k3)
    if BASE_CONV1[path1.shape[3]] == "wmma":
        raise ValueError(f"head_tail_stages: C={path1.shape[3]} runs the wmma "
                         f"chain, which has no stages")
    return _launch_base(path1, args, out_hw)


@functools.lru_cache(maxsize=None)
def _host_taps(n_in: int, n_out: int,
               dt: torch.dtype = torch.bfloat16
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Per output column of the align-corners W-resize n_in -> n_out: the two
    input columns (int32, (2, n_out)) and their weights rounded to ``dt``,
    as f32 ((2, n_out)), from the same matrix the plain version multiplies
    by in that dtype."""
    m = torch.as_tensor(linear_weights(n_in, n_out, align_corners=True),
                        dtype=dt).float().numpy()
    idx = np.zeros((2, n_out), np.int32)
    wts = np.zeros((2, n_out), np.float32)
    for k in range(n_out):
        cols = np.flatnonzero(m[k])
        if not 1 <= len(cols) <= 2:
            raise ValueError(f"resize row {k} has {len(cols)} taps")
        idx[:, k] = cols[0], cols[-1]
        wts[0, k] = m[k, cols[0]]
        wts[1, k] = m[k, cols[1]] if len(cols) == 2 else 0.0
    return idx, wts


_ON_DEVICE: Dict[tuple, Tuple[torch.Tensor, ...]] = {}


def _on_device(tables, n_in: int, n_out: int, device: torch.device, *args):
    """The host tables ``tables(n_in, n_out, *args)`` on ``device``, copied
    once (a copy inside a step would synchronise the stream)."""
    key = (tables, n_in, n_out, device, *args)
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = tuple(torch.as_tensor(t, device=device)
                                for t in tables(n_in, n_out, *args))
    return _ON_DEVICE[key]


def _device_taps(n_in: int, n_out: int, device: torch.device,
                 dt: torch.dtype = torch.bfloat16):
    """The W-resize tap tables on ``device``, weights rounded to ``dt``."""
    return _on_device(_host_taps, n_in, n_out, device, dt)


_PREPARED: Dict[tuple, tuple] = {}


def _prepared(build, weights: Tuple[torch.Tensor, ...], *args):
    """``build(*weights, *args)``, kept for these weight tensors as they are:
    rebuilt when one of them is another tensor or has been written in place
    since (its version counter), dropped when one of them is freed. Inference
    tensors, whose writes are not counted, are never kept. A kernel wrapper
    thus rebuilds its weight layouts once per set of weights, not per call."""
    if any(w.is_inference() for w in weights):
        return build(*weights, *args)
    key = (build, *(id(w) for w in weights), *args)
    versions = tuple(w._version for w in weights)
    hit = _PREPARED.get(key)
    if hit is not None and hit[1] == versions and all(
            r() is w for r, w in zip(hit[0], weights)):
        return hit[2]
    value = build(*weights, *args)
    drop = lambda _, k=key: _PREPARED.pop(k, None)  # noqa: E731
    _PREPARED[key] = (tuple(weakref.ref(w, drop) for w in weights), versions,
                      value)
    return value


def _f32_vectors(*ts):
    """The tensors flattened, as f32 vectors on their device (copies: no
    prepared tensor is a view of a weight, so a freed weight frees them)."""
    return [t.to(torch.float32, copy=True).reshape(-1) for t in ts]


def _ext_weights(k_oc, b_oc, k1, b1, k2, b2, k3, b3):
    """Row 7's weights as vrvg_head_tail_ext_front and the row-12 back read
    them: the mix (C, C) bf16; conv1 as the GEMM's B (C2 > 32) or the halo
    kernel's rows (C2 = 32); conv2's rows; the f32 vectors b_oc, b1, b2, the
    1x1, b3."""
    w1 = conv2_weights(k1) if k1.shape[0] == C3 else conv3x3_gemm_weights(k1)
    return (k_oc[:, :, 0, 0].to(torch.bfloat16, copy=True), w1,
            conv2_weights(k2), *_f32_vectors(b_oc, b1, b2, k3, b3))


def _ext_f32_weights(k_oc, b_oc, k1, b1, k2, b2, k3, b3):
    """Row 7's weights as vrvg_head_tail_ext_f32 reads them: the mix (C, C)
    split for the 3xTF32 core's dense product (ops/mlp.tf32x3_split_kernel),
    conv1 and conv2 split for its conv (:func:`_conv_split`), and the f32
    vectors b_oc, b1, b2, the 1x1, b3. Kept by :func:`_prepared`, so a path
    splits them at its first (eager) step and never inside a CUDA graph
    capture."""
    mix = k_oc[:, :, 0, 0].to(torch.float32).contiguous()
    return (tf32x3_split_kernel(mix), _conv_split(k1), _conv_split(k2),
            *_f32_vectors(b_oc, b1, b2, k3, b3))


def _ext32_weights(k_oc, b_oc, k1, b1, k2, b2, k3, b3):
    """The C = 32 chain's weights (csrc/head_tail.cu): the mix, conv1 (3, 3,
    C, C2) and conv2 (3, 3, C2, C3) bf16, and the f32 vectors."""
    bf16 = torch.bfloat16
    return (k_oc[:, :, 0, 0].to(bf16, copy=True),
            k1.to(bf16).permute(2, 3, 1, 0).contiguous(),
            k2.to(bf16).permute(2, 3, 1, 0).contiguous(),
            *_f32_vectors(b_oc, b1, b2, k3, b3))


def _check_ext(x: torch.Tensor, k_oc, k1, k2, k3) -> None:
    c = x.shape[3]
    c2 = c // 2
    if x.dtype == torch.float32:
        if not takes_f32(c):
            raise ValueError(f"head_tail_ext f32 kernel takes C in "
                             f"{EXT_F32_CHANNELS}, got C={c}")
    elif x.dtype != torch.bfloat16 or not takes(c, x.shape[2]):
        raise ValueError(f"head_tail_ext kernel takes bf16 input with C in "
                         f"{CHANNELS} (at C=32 rows within {SMEM_PER_BLOCK} "
                         f"bytes of shared memory), or f32 input with C in "
                         f"{EXT_F32_CHANNELS}, got {x.dtype} C={c} "
                         f"W0={x.shape[2]}")
    for name, t, shape in (("out_conv", k_oc, (c, c, 1, 1)),
                           ("output_conv1", k1, (c2, c, 3, 3)),
                           ("output_conv2.0", k2, (C3, c2, 3, 3)),
                           ("output_conv2.2", k3, (1, C3, 1, 1))):
        if tuple(t.shape) != shape:
            raise ValueError(f"head_tail_ext {name} weight must be {shape}, "
                             f"got {tuple(t.shape)}")


def _channels_last(x: torch.Tensor):
    """x (B, H0, W0, C) as the chains read it: (x, nchw, xt) with nchw when x
    is an NCHW tensor seen as NHWC (the model's), which the kernels
    transpose first into the scratch xt; any other strides copied to a
    contiguous x."""
    nchw = not x.is_contiguous() and x.permute(0, 3, 1, 2).is_contiguous()
    if not nchw:
        x = x.contiguous()
    xt = torch.empty_like(x, memory_format=torch.contiguous_format) \
        if nchw else x
    return x, nchw, xt


def head_tail_ext(x: torch.Tensor, k_oc: torch.Tensor, b_oc: torch.Tensor,
                  k1: torch.Tensor, b1: torch.Tensor, k2: torch.Tensor,
                  b2: torch.Tensor, k3: torch.Tensor, b3: torch.Tensor,
                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """x (B, H0, W0, C), any strides -> depth (B, H1, W1) f32: the plain
    version for CPU tensors, the kernels for CUDA tensors (bf16, C in
    ``CHANNELS``): the five-stage chain at ``EXT_CHANNELS``, the older
    chain of csrc/head_tail.cu at C = 32; f32 (C in ``EXT_F32_CHANNELS``):
    the f32 chain."""
    args = (k_oc, b_oc, k1, b1, k2, b2, k3, b3)
    if not on_cuda(x, *args):
        return head_tail_ext_plain(x, *args, out_hw)
    if x.shape[3] in EXT_CHANNELS or x.dtype == torch.float32:
        return head_tail_ext_stages(x, *args, out_hw)[-1]
    _check_ext(x, k_oc, k1, k2, k3)
    from vr_video_generator_tpu_torch.kernels.build import check, library

    b, h0, w0, c = x.shape
    h1, w1 = out_hw
    koc, wt1, wt2, *vecs = _prepared(_ext32_weights, args)
    taps_a, tapw_a = _device_taps(w0, 2 * w0, x.device)
    taps_b, tapw_b = _device_taps(2 * w0, w1, x.device)
    bf16 = torch.bfloat16
    rw = torch.empty((b, h0, 2 * w0, c), dtype=bf16, device=x.device)
    c1 = torch.empty((b, 2 * h0, 2 * w0, c // 2), dtype=bf16, device=x.device)
    out = torch.empty((b, h1, w1), dtype=torch.float32, device=x.device)
    err = library().vrvg_head_tail_ext(
        x.data_ptr(), *x.stride(), b, h0, w0, c, koc.data_ptr(),
        vecs[0].data_ptr(), wt1.data_ptr(), vecs[1].data_ptr(),
        wt2.data_ptr(), vecs[2].data_ptr(), vecs[3].data_ptr(),
        vecs[4].data_ptr(), taps_a.data_ptr(), tapw_a.data_ptr(),
        taps_b.data_ptr(), tapw_b.data_ptr(), rw.data_ptr(), c1.data_ptr(),
        out.data_ptr(), h1, w1, stream_handle(x.device))
    check(err, "vrvg_head_tail_ext")
    LAUNCHES.count += 1
    return out


def head_tail_ext_stages(x: torch.Tensor, k_oc: torch.Tensor,
                         b_oc: torch.Tensor, k1: torch.Tensor,
                         b1: torch.Tensor, k2: torch.Tensor, b2: torch.Tensor,
                         k3: torch.Tensor, b3: torch.Tensor,
                         out_hw: Tuple[int, int]):
    """Row 7 stage by stage: (xoc, Z, c1, R, depth), each (B, H, W, C)
    channels-last but the f32 depth (B, H1, W1). For CPU tensors, the plain
    versions of the stages; for CUDA tensors (bf16, C in ``EXT_CHANNELS``,
    or f32, C in ``EXT_F32_CHANNELS``), one launch of the chain (the front
    and the back entry points; at f32 the one f32 entry point), whose
    scratch holds the intermediates."""
    args = (k_oc, b_oc, k1, b1, k2, b2, k3, b3)
    if not on_cuda(x, *args):
        xoc = ext_mix_plain(x, k_oc)
        z = big_upsample_plain(xoc, b_oc)
        c1 = ext_conv1_plain(z, k1, b1)
        r = ext_resize_plain(c1, out_hw)
        return xoc, z, c1, r, big_conv2_plain(r, k2, b2, k3, b3)
    _check_ext(x, k_oc, k1, k2, k3)
    if x.dtype == torch.float32:
        return _ext_f32_stages(x, args, out_hw)
    b, h0, w0, c = x.shape
    if c not in EXT_CHANNELS:
        raise ValueError(f"head_tail_ext_stages takes C in {EXT_CHANNELS}, "
                         f"got C={c}")
    from vr_video_generator_tpu_torch.kernels.build import check, library

    h1, w1 = out_hw
    hm, w2, c2 = 2 * h0, 2 * w0, c // 2
    koc, w1m, w2m, boc, b1f, b2f, w3f, b3f = _prepared(_ext_weights, args)
    x, nchw, xt = _channels_last(x)
    taps_a, tapw_a = _device_taps(w0, w2, x.device)
    taps_b, tapw_b = _device_taps(w2, w1, x.device)
    new = functools.partial(torch.empty, dtype=torch.bfloat16,
                            device=x.device)
    xoc, z, c1, r = (new((b, h0, w0, c)), new((b, hm, w2, c)),
                     new((b, hm, w2, c2)), new((b, h1, w1, c2)))
    out = torch.empty((b, h1, w1), dtype=torch.float32, device=x.device)
    lib, stream = library(), stream_handle(x.device)
    check(lib.vrvg_head_tail_ext_front(
        x.data_ptr(), int(nchw), xt.data_ptr(), koc.data_ptr(),
        boc.data_ptr(), taps_a.data_ptr(), tapw_a.data_ptr(), xoc.data_ptr(),
        z.data_ptr(), w1m.data_ptr(), b1f.data_ptr(), c1.data_ptr(), b, h0,
        w0, c, stream), "vrvg_head_tail_ext_front")
    check(lib.vrvg_head_tail_big_back(
        c1.data_ptr(), taps_b.data_ptr(), tapw_b.data_ptr(), None,
        w2m.data_ptr(), b2f.data_ptr(), w3f.data_ptr(), b3f.data_ptr(),
        r.data_ptr(), out.data_ptr(), b, hm, w2, c2, h1, w1, stream),
        "vrvg_head_tail_big_back")
    LAUNCHES.count += 1
    return xoc, z, c1, r, out


def _ext_f32_stages(x: torch.Tensor, args, out_hw: Tuple[int, int]):
    """Row 7 at f32 on the card: (xoc, Z, c1, R, depth) from one launch of
    vrvg_head_tail_ext_f32 (x checked by :func:`_check_ext`)."""
    from vr_video_generator_tpu_torch.kernels.build import check, library

    b, h0, w0, c = x.shape
    h1, w1 = out_hw
    hm, w2, c2 = 2 * h0, 2 * w0, c // 2
    kocs, w1s, w2s, boc, b1f, b2f, w3f, b3f = _prepared(_ext_f32_weights,
                                                        args)
    x, nchw, xt = _channels_last(x)
    f32 = torch.float32
    taps_a, tapw_a = _device_taps(w0, w2, x.device, f32)
    taps_b, tapw_b = _device_taps(w2, w1, x.device, f32)
    new = functools.partial(torch.empty, dtype=f32, device=x.device)
    xoc, z, c1, r = (new((b, h0, w0, c)), new((b, hm, w2, c)),
                     new((b, hm, w2, c2)), new((b, h1, w1, c2)))
    out = new((b, h1, w1))
    check(library().vrvg_head_tail_ext_f32(
        x.data_ptr(), int(nchw), xt.data_ptr(), kocs.data_ptr(),
        boc.data_ptr(), taps_a.data_ptr(), tapw_a.data_ptr(), xoc.data_ptr(),
        z.data_ptr(), w1s.data_ptr(), b1f.data_ptr(), c1.data_ptr(),
        taps_b.data_ptr(), tapw_b.data_ptr(), r.data_ptr(), w2s.data_ptr(),
        b2f.data_ptr(), w3f.data_ptr(), b3f.data_ptr(), out.data_ptr(), b,
        h0, w0, c, h1, w1, stream_handle(x.device)),
        "vrvg_head_tail_ext_f32")
    F32_LAUNCHES.count += 1
    return xoc, z, c1, r, out


# --- the big-C tail (rows 11, 12) ---------------------------------------------

def fold_conv1(k_oc: torch.Tensor, k1: torch.Tensor,
               dt: torch.dtype) -> torch.Tensor:
    """out_conv's 1x1 mix folded into conv1's weights in f32, cast to ``dt``:
    (C2, C, 3, 3), K1'[o, i] = sum_j OC[j, i] K1[o, j]."""
    return torch.einsum("ji,ojhw->oihw", k_oc[:, :, 0, 0].float(),
                        k1.float()).to(dt)


@functools.lru_cache(maxsize=None)
def _host_bias_tables(w2: int, w1: int):
    """(3, W2) masks of the image columns where conv1's width taps dw = 0,
    1, 2 fall inside the image; (3, 3) masks of the kernel rows dh each row
    case keeps (interior: all, top: 1 and 2, bottom: 0 and 1); and the f32
    (W2, W1) W-resize matrix."""
    cm = np.zeros((3, w2), np.float32)
    cm[0, 1:] = 1.0
    cm[1, :] = 1.0
    cm[2, :w2 - 1] = 1.0
    rows = np.array([[1, 1, 1], [0, 1, 1], [1, 1, 0]], np.float32)
    return (cm, rows,
            linear_weights(w2, w1, align_corners=True).T.astype(np.float32))


def big_tail_bias(k1: torch.Tensor, b_oc: torch.Tensor, b1: torch.Tensor,
                  w2: int, w1: int) -> torch.Tensor:
    """``cw`` of head_tail_big_pallas (:716-735), in f32: for the interior,
    top and bottom rows, conv1's response to the out_conv-bias image with
    zero padding, plus b1, through the f32 W-resize. Returned as (3, W1, C2):
    cw0, cw1 - cw0 and cw2 - cw0, the three terms the intermediate adds. The
    three row cases are products with (3, 3) row masks: a few launches and
    little host time a call (a sum of taps per case took ~50 launches)."""
    cm, rows, wtb = _on_device(_host_bias_tables, w2, w1, k1.device)
    c2 = k1.shape[0]
    base = k1.float().permute(2, 3, 0, 1) @ b_oc.float()  # (3, 3, C2)
    # The case's kernel rows, then the image columns each width tap reaches.
    per_dw = (rows @ base.reshape(3, 3 * c2)).reshape(3, 3, c2)
    corr = per_dw.transpose(1, 2) @ cm  # (3, C2, W2)
    cw = ((corr + b1.float()[:, None] * cm[1]) @ wtb).transpose(1, 2)
    return torch.stack([cw[0], cw[1] - cw[0], cw[2] - cw[0]])


def big_upsample_plain(x: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row 11's first stage (and row 7's second, with its out_conv bias): x
    (B, H0, W0, C) -> U (B, 2 H0, 2 W0, C) in x's dtype: the W-upsample
    (bf16 resize weights, f32 sums) -> dtype, the H-upsample (exact taps, f32
    lerp, + the f32 ``bias`` where given) -> dtype."""
    dt = x.dtype
    _, h0, w0, _ = x.shape
    wta = _resize_matrix(w0, 2 * w0, dt, x.device)
    rw = torch.einsum("bhwc,vw->bhvc", x.float(), wta).to(dt)
    u = _hlerp(rw.float(), 2 * h0, 1)
    if bias is not None:
        u = u + bias.to(torch.float32)
    return u.to(dt)


def big_conv1_plain(u: torch.Tensor, k_oc: torch.Tensor,
                    k1: torch.Tensor) -> torch.Tensor:
    """Row 11's second stage: U (B, HM, W2, C) -> the post-conv1 product (B,
    HM, W2, C2) in U's dtype: the folded 3x3 conv1 in f32 with zero padding
    and no bias -> dtype."""
    dt = u.dtype
    c1 = F.conv2d(u.permute(0, 3, 1, 2).float(),
                  fold_conv1(k_oc, k1, dt).float(), padding=1)
    return c1.to(dt).permute(0, 2, 3, 1).contiguous()


def head_tail_big_front_plain(x: torch.Tensor, k_oc: torch.Tensor,
                              k1: torch.Tensor) -> torch.Tensor:
    """x (B, H0, W0, C) -> the post-conv1 product (B, 2 H0, 2 W0, C2) in x's
    dtype: :func:`big_upsample_plain`, then :func:`big_conv1_plain`."""
    return big_conv1_plain(big_upsample_plain(x), k_oc, k1)


def big_resize_plain(mid: torch.Tensor, k1: torch.Tensor, b_oc: torch.Tensor,
                     b1: torch.Tensor,
                     out_hw: Tuple[int, int]) -> torch.Tensor:
    """Row 12's first stage: mid (B, HM, W2, C2) -> R (B, H1, W1, C2) in
    mid's dtype: the W-resize (f32) + (cw0 + top * dtop + bot * dbot) ->
    dtype (the TPU's intermediate), the H-resize (f32 lerp) -> dtype."""
    dt = mid.dtype
    _, hm, w2, _ = mid.shape
    h1, w1 = out_hw
    zw = torch.einsum("bhwc,vw->bhvc", mid.float(),
                      _resize_matrix(w2, w1, dt, mid.device))
    cw = big_tail_bias(k1, b_oc, b1, w2, w1)
    t = zw + cw[0]
    t[:, 0] = t[:, 0] + cw[1]
    t[:, hm - 1] = t[:, hm - 1] + cw[2]
    return _hlerp(t.to(dt).float(), h1, 1).to(dt)


def big_conv2_plain(r: torch.Tensor, k2: torch.Tensor, b2: torch.Tensor,
                    k3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """Row 12's second stage: R (B, H1, W1, C2) -> depth (B, H1, W1) f32: b2
    + conv2 in f32 with zero padding, ReLU, the f32 1x1 + b3, ReLU."""
    y = F.conv2d(r.permute(0, 3, 1, 2).float(), k2.to(r.dtype).float(),
                 padding=1)
    y = F.relu(b2.float()[None, :, None, None] + y)
    res = (y * k3[0, :, 0, 0].float()[:, None, None]).sum(dim=1) + b3.float()
    return F.relu(res)


def head_tail_big_back_plain(mid: torch.Tensor, k1: torch.Tensor,
                             b_oc: torch.Tensor, b1: torch.Tensor,
                             k2: torch.Tensor, b2: torch.Tensor,
                             k3: torch.Tensor, b3: torch.Tensor,
                             out_hw: Tuple[int, int]) -> torch.Tensor:
    """mid (B, HM, W2, C2) -> depth (B, H1, W1) f32: :func:`big_resize_plain`,
    then :func:`big_conv2_plain`."""
    return big_conv2_plain(big_resize_plain(mid, k1, b_oc, b1, out_hw),
                           k2, b2, k3, b3)


def head_tail_big_plain(x: torch.Tensor, k_oc: torch.Tensor,
                        b_oc: torch.Tensor, k1: torch.Tensor,
                        b1: torch.Tensor, k2: torch.Tensor, b2: torch.Tensor,
                        k3: torch.Tensor, b3: torch.Tensor,
                        out_hw: Tuple[int, int]) -> torch.Tensor:
    """x (B, H0, W0, C) -> depth (B, H1, W1) f32, head_tail_big_pallas's
    function. Weights in PyTorch layout, as head_tail_ext_plain's."""
    mid = head_tail_big_front_plain(x, k_oc, k1)
    return head_tail_big_back_plain(mid, k1, b_oc, b1, k2, b2, k3, b3, out_hw)


def conv3x3_gemm_weights(k: torch.Tensor,
                         dt: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """A 3x3 conv (O, I, 3, 3) as the GEMM core's B for Conv3x3Layout: (O,
    9 I) bf16, k = (3 dh + dw) I + i (row 7's conv1); with ``dt`` f32, the
    f32 weights that :func:`_conv_split` splits for the 3xTF32 core."""
    k = k.to(dt)
    return k.permute(0, 2, 3, 1).reshape(k.shape[0], -1).contiguous()


def conv1_weights(k_oc: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    """conv1 with out_conv's mix folded in, as the GEMM's B: (C2, 9 C) bf16,
    k = (3 dh + dw) C + c."""
    return conv3x3_gemm_weights(fold_conv1(k_oc, k1, torch.bfloat16))


def conv2_weights(k2: torch.Tensor) -> torch.Tensor:
    """A 3x3 conv to 32 channels (32, C2, 3, 3) as the halo kernel reads it
    (row 12's conv2, row 7's conv1 at C2 = 32): (9 * 32, C2) bf16, row (3 dh
    + dw) 32 + n."""
    return k2.to(torch.bfloat16).permute(2, 3, 0, 1).reshape(
        9 * k2.shape[0], k2.shape[1]).contiguous()


def head_tail_big_front(x: torch.Tensor, k_oc: torch.Tensor,
                        k1: torch.Tensor) -> torch.Tensor:
    """x (B, H0, W0, C), any strides -> (B, 2 H0, 2 W0, C2): the plain
    version for CPU tensors, the row-11 kernels for CUDA tensors (bf16, C in
    ``BIG_CHANNELS``)."""
    return head_tail_big_front_stages(x, k_oc, k1)[1]


def head_tail_big_front_stages(x: torch.Tensor, k_oc: torch.Tensor,
                               k1: torch.Tensor):
    """Row 11 stage by stage: (U, mid). For CPU tensors, the plain versions
    of the stages; for CUDA tensors, one launch of the chain (an NCHW x
    transposed first, the upsample pass, conv1), whose scratch holds U."""
    if not on_cuda(x, k_oc, k1):
        u = big_upsample_plain(x)
        return u, big_conv1_plain(u, k_oc, k1)
    b, h0, w0, c = x.shape
    c2 = c // 2
    if x.dtype != torch.bfloat16 or not big_takes(c):
        raise ValueError(f"head_tail_big_front kernel takes bf16 input with "
                         f"C in {BIG_CHANNELS}, got {x.dtype} C={c}")
    for name, t, shape in (("out_conv", k_oc, (c, c, 1, 1)),
                           ("output_conv1", k1, (c2, c, 3, 3))):
        if tuple(t.shape) != shape:
            raise ValueError(f"head_tail_big_front {name} weight must be "
                             f"{shape}, got {tuple(t.shape)}")
    from vr_video_generator_tpu_torch.kernels.build import check, library

    x, nchw, xt = _channels_last(x)
    w1m = _prepared(conv1_weights, (k_oc, k1))
    taps, tapw = _device_taps(w0, 2 * w0, x.device)
    u = torch.empty((b, 2 * h0, 2 * w0, c), dtype=torch.bfloat16,
                    device=x.device)
    mid = torch.empty((b, 2 * h0, 2 * w0, c2), dtype=torch.bfloat16,
                      device=x.device)
    err = library().vrvg_head_tail_big_front(
        x.data_ptr(), int(nchw), xt.data_ptr(), w1m.data_ptr(),
        taps.data_ptr(), tapw.data_ptr(), u.data_ptr(), mid.data_ptr(), b, h0,
        w0, c, stream_handle(x.device))
    check(err, "vrvg_head_tail_big_front")
    BIG_FRONT_LAUNCHES.count += 1
    return u, mid


def head_tail_big_back(mid: torch.Tensor, k1: torch.Tensor,
                       b_oc: torch.Tensor, b1: torch.Tensor, k2: torch.Tensor,
                       b2: torch.Tensor, k3: torch.Tensor, b3: torch.Tensor,
                       out_hw: Tuple[int, int]) -> torch.Tensor:
    """mid (B, HM, W2, C2) contiguous -> depth (B, H1, W1) f32: the plain
    version for CPU tensors, the row-12 kernels for CUDA tensors (bf16, C2
    in ``BIG_CHANNELS`` / 2)."""
    return head_tail_big_back_stages(mid, k1, b_oc, b1, k2, b2, k3, b3,
                                     out_hw)[1]


def head_tail_big_back_stages(mid: torch.Tensor, k1: torch.Tensor,
                              b_oc: torch.Tensor, b1: torch.Tensor,
                              k2: torch.Tensor, b2: torch.Tensor,
                              k3: torch.Tensor, b3: torch.Tensor,
                              out_hw: Tuple[int, int]):
    """Row 12 stage by stage: (R, depth). For CPU tensors, the plain
    versions of the stages; for CUDA tensors, one launch of the resize pass
    and conv2, whose scratch holds R."""
    args = (k1, b_oc, b1, k2, b2, k3, b3)
    if not on_cuda(mid, *args):
        r = big_resize_plain(mid, k1, b_oc, b1, out_hw)
        return r, big_conv2_plain(r, k2, b2, k3, b3)
    b, hm, w2, c2 = mid.shape
    h1, w1 = out_hw
    if (mid.dtype != torch.bfloat16 or not big_takes(2 * c2)
            or not mid.is_contiguous()):
        raise ValueError(f"head_tail_big_back kernel takes contiguous bf16 "
                         f"input with C2 in {[c // 2 for c in BIG_CHANNELS]}, "
                         f"got {mid.dtype} C2={c2} "
                         f"contiguous={mid.is_contiguous()}")
    for name, t, shape in (("output_conv1", k1, (c2, 2 * c2, 3, 3)),
                           ("output_conv2.0", k2, (C3, c2, 3, 3)),
                           ("output_conv2.2", k3, (1, C3, 1, 1))):
        if tuple(t.shape) != shape:
            raise ValueError(f"head_tail_big_back {name} weight must be "
                             f"{shape}, got {tuple(t.shape)}")
    from vr_video_generator_tpu_torch.kernels.build import check, library

    cw = _prepared(big_tail_bias, (k1, b_oc, b1), w2, w1)
    w2m = _prepared(conv2_weights, (k2,))
    vecs = _prepared(_f32_vectors, (b2, k3, b3))
    taps, tapw = _device_taps(w2, w1, mid.device)
    r = torch.empty((b, h1, w1, c2), dtype=torch.bfloat16, device=mid.device)
    out = torch.empty((b, h1, w1), dtype=torch.float32, device=mid.device)
    err = library().vrvg_head_tail_big_back(
        mid.data_ptr(), taps.data_ptr(), tapw.data_ptr(), cw.data_ptr(),
        w2m.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
        vecs[2].data_ptr(), r.data_ptr(), out.data_ptr(), b, hm, w2, c2, h1,
        w1, stream_handle(mid.device))
    check(err, "vrvg_head_tail_big_back")
    BIG_BACK_LAUNCHES.count += 1
    return r, out


def head_tail_big(x: torch.Tensor, k_oc: torch.Tensor, b_oc: torch.Tensor,
                  k1: torch.Tensor, b1: torch.Tensor, k2: torch.Tensor,
                  b2: torch.Tensor, k3: torch.Tensor, b3: torch.Tensor,
                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """x (B, H0, W0, C) -> depth (B, H1, W1) f32 through the front and the
    back (each its kernel on the card, its plain version on the CPU); an
    f32 x on the card through the f32 chain (``vrvg_head_tail_big_f32``, C
    in ``EXT_F32_CHANNELS``)."""
    args = (k_oc, b_oc, k1, b1, k2, b2, k3, b3)
    if x.dtype == torch.float32 and on_cuda(x, *args):
        return _big_f32_stages(x, args, out_hw)[-1]
    mid = head_tail_big_front(x, k_oc, k1)
    return head_tail_big_back(mid, k1, b_oc, b1, k2, b2, k3, b3, out_hw)


def head_tail_big_stages(x: torch.Tensor, k_oc: torch.Tensor,
                         b_oc: torch.Tensor, k1: torch.Tensor,
                         b1: torch.Tensor, k2: torch.Tensor, b2: torch.Tensor,
                         k3: torch.Tensor, b3: torch.Tensor,
                         out_hw: Tuple[int, int]):
    """Rows 11 and 12 stage by stage: (U, mid, R, depth), each (B, H, W, C)
    channels-last but the f32 depth (B, H1, W1). For CPU tensors, the plain
    versions of the stages; for CUDA tensors, the front's and the back's
    launches (bf16), or one launch of the f32 chain (f32, C in
    ``EXT_F32_CHANNELS``), whose scratch holds the intermediates."""
    args = (k_oc, b_oc, k1, b1, k2, b2, k3, b3)
    if x.dtype == torch.float32 and on_cuda(x, *args):
        return _big_f32_stages(x, args, out_hw)
    u, mid = head_tail_big_front_stages(x, k_oc, k1)
    return (u, mid, *head_tail_big_back_stages(mid, k1, b_oc, b1, k2, b2, k3,
                                               b3, out_hw))


def _conv_split(k: torch.Tensor) -> torch.Tensor:
    """A 3x3 conv (O, I, 3, 3) as the 3xTF32 core's B: its f32 (O, 9 I)
    GEMM weights (:func:`conv3x3_gemm_weights`), k = (3 dh + dw) I + i,
    split into TF32 hi/lo planes (2, 128 ceil(O / 128), 9 I)
    (ops/mlp.tf32x3_split_kernel)."""
    return tf32x3_split_kernel(conv3x3_gemm_weights(k, torch.float32))


def _big_f32_weights(k_oc, k1, k2, b2, k3, b3):
    """Rows 11 and 12's weights as vrvg_head_tail_big_f32 reads them: conv1
    with out_conv's mix folded in f32 and conv2, each split for the 3xTF32
    core (:func:`_conv_split`); the f32 vectors b2, the 1x1, b3. Kept by
    :func:`_prepared`, so a path splits them at its first (eager) step and
    never inside a CUDA graph capture."""
    return (_conv_split(fold_conv1(k_oc, k1, torch.float32)),
            _conv_split(k2), *_f32_vectors(b2, k3, b3))


def _big_f32_stages(x: torch.Tensor, args, out_hw: Tuple[int, int]):
    """Rows 11 and 12 at f32 on the card: (U, mid, R, depth) from one launch
    of vrvg_head_tail_big_f32."""
    k_oc, b_oc, k1, b1, k2, b2, k3, b3 = args
    b, h0, w0, c = x.shape
    h1, w1 = out_hw
    hm, w2, c2 = 2 * h0, 2 * w0, c // 2
    if not takes_f32(c):
        raise ValueError(f"head_tail_big f32 kernel takes C in "
                         f"{EXT_F32_CHANNELS}, got C={c}")
    for name, t, shape in (("out_conv", k_oc, (c, c, 1, 1)),
                           ("output_conv1", k1, (c2, c, 3, 3)),
                           ("output_conv2.0", k2, (C3, c2, 3, 3)),
                           ("output_conv2.2", k3, (1, C3, 1, 1))):
        if tuple(t.shape) != shape:
            raise ValueError(f"head_tail_big {name} weight must be {shape}, "
                             f"got {tuple(t.shape)}")
    from vr_video_generator_tpu_torch.kernels.build import check, library

    w1s, w2s, b2f, w3f, b3f = _prepared(_big_f32_weights,
                                        (k_oc, k1, k2, b2, k3, b3))
    cw = _prepared(big_tail_bias, (k1, b_oc, b1), w2, w1)
    x, nchw, xt = _channels_last(x)
    f32 = torch.float32
    taps_a, tapw_a = _device_taps(w0, w2, x.device, f32)
    taps_b, tapw_b = _device_taps(w2, w1, x.device, f32)
    new = functools.partial(torch.empty, dtype=f32, device=x.device)
    u, mid, r = new((b, hm, w2, c)), new((b, hm, w2, c2)), new((b, h1, w1, c2))
    out = new((b, h1, w1))
    check(library().vrvg_head_tail_big_f32(
        x.data_ptr(), int(nchw), xt.data_ptr(), w1s.data_ptr(),
        taps_a.data_ptr(), tapw_a.data_ptr(), u.data_ptr(), mid.data_ptr(),
        taps_b.data_ptr(), tapw_b.data_ptr(), cw.data_ptr(), r.data_ptr(),
        w2s.data_ptr(), b2f.data_ptr(), w3f.data_ptr(), b3f.data_ptr(),
        out.data_ptr(), b, h0, w0, c, h1, w1, stream_handle(x.device)),
        "vrvg_head_tail_big_f32")
    BIG_F32_LAUNCHES.count += 1
    return u, mid, r, out


def conv3x3_f32_plain(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) -> the 3x3 conv's sums (B, H, W, O) with zero padding
    and no bias, in x's dtype, k (O, C, 3, 3)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), k.to(x.dtype), padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def conv3x3_f32(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """:func:`conv3x3_f32_plain` of f32 x: the plain version for CPU tensors,
    for CUDA tensors ``vrvg_conv3x3_f32``, a conv of rows 11 and 12 at f32
    alone on the 3xTF32 core (C a multiple of 32, O in
    ``CONV3X3_F32_OUT``), k split once (:func:`_prepared`)."""
    if not on_cuda(x, k):
        return conv3x3_f32_plain(x, k)
    b, h, w, c = x.shape
    n = k.shape[0]
    if (x.dtype != torch.float32 or k.dtype != torch.float32 or c % 32
            or n not in CONV3X3_F32_OUT or tuple(k.shape) != (n, c, 3, 3)):
        raise ValueError(f"conv3x3_f32 takes f32 x (B, H, W, C), C a multiple "
                         f"of 32, and an f32 (O, C, 3, 3) weight with O in "
                         f"{CONV3X3_F32_OUT}, got {x.dtype} {tuple(x.shape)} "
                         f"and {k.dtype} {tuple(k.shape)}")
    from vr_video_generator_tpu_torch.kernels.build import check, library

    x = x.contiguous()
    ks = _prepared(_conv_split, (k,))
    out = torch.empty((b, h, w, n), dtype=torch.float32, device=x.device)
    check(library().vrvg_conv3x3_f32(
        x.data_ptr(), ks.data_ptr(), out.data_ptr(), b, h, w, c, n,
        stream_handle(x.device)), "vrvg_conv3x3_f32")
    CONV3X3_F32_LAUNCHES.count += 1
    return out
