"""Check and time the LayerNorm kernel (row 1), LN + qkv (row 5), proj +
LayerScale + residual (row 6), the ext DPT tail (row 7), the MLP half
(rows 8 and 9), the SwiGLU half (row 10), the big-C DPT tail (rows 11 and
12), the warp kernels (rows 3, 4, 13 and 14) and refinenet1's RCU pair (row
16) on the card at the shapes the main paths give them.

    python3 -m vr_video_generator_tpu_torch.gemm_bench [--sass] \
        [--rows 1,5,6,7,9,10,11,12] [--rows 3,4,13,14] [--rows 8,16]
        [--rows 15] [--rows f32] [--rows f32:vits,f32:vitg-518]
        [--rows f32:tail-vitb-518,f32:tail-vitg-126]
        [--rows f32:ext-vits,f32:ext-vitb-252,f32:rcu-64,f32:rcu-128]
        [--rows f32:ln,f32:qkv-vits,f32:qkv-vitb-518]
        [--rows f32:base-64,f32:base-128]

Row 1 at 1080p, batch 8: (19544, 384) (vits), (38280, 1024) (vitl-728),
(19544, 1536) (vitg-518). For the kernel and for one ``F.layer_norm`` call
(never called by the port) on the same seeded rows: the kernel-only device
time (``torch.profiler``, CUDA kernel events, mean over ``CALLS`` calls),
``event_ms`` (CUDA events around one call, median of 20: the host's launch
is inside it), the host time a call (``HOST_CALLS`` calls without a sync,
and one call on an idle device), and the error against the plain version.

Rows 9 and 8, the MLP half: row 9 at M = 19544 (vitl-518, batch 8) and
38280 (vitl-728, batch 8), row 8 at vits' (19544, 384) and vitb-518's
(19544, 768) rows and at D = 128. The device time of each kernel of the
call and the span from the first kernel's start to the last one's end
(profiler), each stage's device time and TFLOP/s (the LayerNorm, fc1 +
GELU, fc2 + residual; on an older tree the one wmma ``mlp_kernel``), the
host time of each CUDA API call it makes, the call's TFLOP/s and
``event_ms``, the error against ``mlp_residual_plain``, and as a yardstick
(no PyTorch call computes the same function) the two cuBLAS products of the
same shapes, ``F.linear`` (M, D) x (4D, D) and (M, 4D) x (D, 4D), timed the
same ways.

Row 16, refinenet1's RCU pair, at vits' (C = 64) and vitb's (C = 128)
widths on refinenet1's 1080p/518 grid (B = 8, 148 x 264; ``chip_smoke``'s
seeded inputs, NCHW tensors seen as NHWC): each kernel of a call in launch
order (the ReLU pass by its GB/s, each conv by its TFLOP/s; the wrapper's
copies of strided inputs, and an older tree's per-call weight copies, left
out), the chain's sum, ``event_ms``, the error against the plain version,
the bound, and cuDNN's bf16 channels-last ``F.conv2d`` of one conv (+ bias)
as the yardstick. The kernels are found by name, so the file runs unchanged
on an older tree.

Row 5 at vits' (19544, 384), vitb-518's (19544, 768) and vitl-518's
(19544, 1024) rows, and row 10 at vitg-518's (19544 rows, D = 1536, hidden
4096): the same measurements, each stage's TFLOP/s (row 5's GEMM; row 10's gate and down products), and
the cuBLAS products of the same shapes as the yardstick: ``F.linear`` (M,
D) x (3D, D) for row 5, (M, 1536) x (8192, 1536) and (M, 4096) x (1536,
4096) for row 10. The stages are found by kernel name on this tree's
kernels and on the wmma ones before them, so the file runs unchanged on an
older tree.

Row 6 at vits' (19544, 384), vitb-518's (19544, 768) and vitl-518's
(19544, 1024) rows: the same measurements as row 5, with cuBLAS's
``F.linear`` of o (M, D) x (D, D) as the yardstick (the proj product
without the epilogue); the stage is this tree's GEMM core or the wmma
``proj_kernel`` before it.

Row 7, the ext DPT tail, at vits' (C = 64, x 148 x 264, depth 518 x 924),
vitb's (C = 128, the same grid), vitl-252's (C = 256, 72 x 128, 252 x 448)
and vitg-126's (C = 384, 36 x 64, 126 x 224) shapes, batch 8, x an NCHW
tensor seen as NHWC: the device time by stage (the transpose, the out_conv
mix, the upsample pass, conv1, the resize pass and conv2; on an older tree
its three wmma kernels), each stage's TFLOP/s or GB/s, the span,
``event_ms``, the host time a call (on an idle device too), the error
against the plain version, the bound, and cuDNN's two bf16 channels-last
convolutions (conv1, conv2) of the same shapes as the yardstick.

Row 15, the single-kernel DPT tail, at vits' (C = 64) and vitb's (C = 128)
widths on path1 at 1080p/518 (B = 8, 296 x 528, depth 518 x 924;
``chip_smoke``'s seeded weights, path1 an NCHW tensor seen as NHWC): the
device time by stage (the transpose, conv1, the resize pass and conv2; on an
older tree its two wmma kernels), each stage's TFLOP/s or GB/s, the span,
``event_ms``, the host time a call, the error against the plain version, the
bound, and cuDNN's two bf16 channels-last convolutions (conv1 on path1 with
its bias, conv2) of the same shapes as the yardstick. Row 7 at vitb runs the
same conv1 shape on 256 x 128 tiles, row 15 at C = 128 on 256 x 64 ones.

Rows 11 and 12, the big-C DPT tail, at vitl-518's (C = 256, x 148 x 264,
depth 518 x 924), vitl-728's (C = 256, 208 x 368, 728 x 1288) and
vitg-518's (C = 384, 148 x 264, 518 x 924) shapes, batch 8, x an NCHW
tensor seen as NHWC as the model hands it over: each kernel's device time
by stage (the transpose, the upsample pass and conv1; the resize pass and
conv2), each stage's TFLOP/s (the convs) or GB/s (the passes), the span
and ``event_ms`` of a call, the error against the plain version, the bound,
and as a yardstick (the port never calls it) cuDNN's bf16 channels-last
``F.conv2d`` of the same conv1 and conv2 on seeded inputs of their shapes.
The stages are found by kernel name, and the row-12 kernels of an older
tree (``big_front_kernel``, ``big_back_kernel``) count as one stage each.

Rows 3, 4, 13 and 14, the compositor, the blur/select pass, its packed
emit and the banded compositor, at 1080p, batch 8, at two depths whose
data sets their work: ``chip_smoke.py``'s synthetic ramp (0 to 14 plus
noise, through the temporal scan), and the depth of a real vits ``auto``
step (seeded random weights, the depth scaler calibrated to a peak of 12,
as ``stage_bench`` does); rows 3 and 4 also on a 4K ramp, batch 2 (S =
134, kx = 19). For each: the live shifts of each frame, the hole share,
the share of (row, 128-column strip) cells with no hole and of pixels with
a hole within the blur's reach; each kernel's kernel-only time
(profiler), ``event_ms``, host time a call, its bytes (each input read
once, each output written once) over its time, and the bound's share of
its time; each output against its plain version, bit for bit. The rows
call only the wrappers, so the file runs unchanged on an older tree.

``--rows f32``: the f32 variants (``--compute_dtype float32``), at 1080p,
batch 8: row 1 (``f32:ln``) at ``chip_smoke.py`` phase 8's four shapes
(vits' (19544, 384), vitl-728's (9570, 1024) and vitg-518's (4886, 1536)
rows at batch 2, vitg-518's (19544, 1536)) beside ``F.layer_norm`` on f32,
as row 1's bf16 measurement; rows 5 and 6 (``f32:qkv-<label>``: vits' D =
384, vitb-518's 768) as one chain by stage (row 1's f32 LayerNorm, the qkv
product + bias and q's scale, the proj product + bias, LayerScale and
residual; on the 3xTF32 core, or an older tree's SIMT kernels found by
their epilogues' names), each product stage's TFLOP/s and bound share
beside cuBLAS's f32 ``torch.addmm`` of the same product (TF32 off); rows 8
(vits' D = 384) and 9 (vitb-518's 768, vitl-518's 1024) on
the 3xTF32 wgmma core of ``csrc/tf32x3_gemm.cuh`` by stage (row 1's f32
LayerNorm, fc1 + b1 + GELU, fc2 + residual) and row 10 at vitg-518's
(19544, 1536), hidden 4096, by stage (the LayerNorm, the gate + silu, the
down product + residual), the weights split before the timing as a path's
first step splits them, each against cuBLAS's two f32 products of the same
shapes (``torch.addmm``, TF32 off); ``f32:<label>`` (vits, vitb-518,
vitl-518, vitg-518) takes one of those rows alone. Rows 11 and 12 at
vitb-518 (C = 128) by stage (the transpose, the upsample pass, conv1, the
resize pass, conv2 with the 1x1; the convs on the 3xTF32 core), against
cuDNN's f32 convs (TF32 off); ``f32:tail-<label>`` takes them alone at
vitb-518, at vitg-126 (C = 384) or at C = 384 on vitg-518's grid. Row 7 at
vitb-252 (C = 128; ``f32:ext-<label>``: at vitb-252, at vits, C = 64, or
at c32, a 32-feature head's C = 32 on vits' grid, C2 zero-padded) by
stage (the transpose, the mix, the passes, the convs; the products on the
3xTF32 core), against cuDNN's f32 convs (TF32 off). Row 16 at C = 64 and
128 on refinenet1's grid (``f32:rcu-<C>``), each launch of the chain in
order (the ReLU pass, the four convs on the 3xTF32 core), against cuDNN's
f32 conv of one of them. Row 15 at vits' and vitb's path1 (C = 64, 128;
``f32:base-<C>``, also C = 32 on vits' path1 grid) by stage (the transpose, conv1 + b1, the resize pass,
conv2 with the 1x1; the convs on the 3xTF32 core), against cuDNN's two f32
convs (TF32 off). The stages and launches are also found by the kernel
names of an older tree's f32 SIMT FFMA core (``sgemm_kernel``,
``Conv3x3Rows`` and the epilogues' names), so this file, run on such a
tree, measures its rows 5, 6, 7, 15 and 16 the same way, in turns with
this tree's on one card. Each row: the device
time by stage and its TFLOP/s or GB/s, the span, ``event_ms``, the error
against the plain version and the bound at the card's f32-accurate rate
(165 TFLOP/s: a third of its dense TF32 rate, as 3xTF32 takes three TF32
products for one, above the 67 TFLOP/s outside the tensor cores) or its
HBM rate, the bound's share of the kernel-only time and the kernel-only
time over cuDNN's.

Each measurement (one shape of a row) runs in a fresh process
(``utils.profiling.in_fresh_process``): a torch.profiler session a while
after another one in the same process loses the card's events (ROADMAP
fault 5), so each kernel-only time comes from its process's first
profile, and its yardstick's from a session seconds later (the host
timing between them is capped at HOST_SECONDS of calls).

``--sass`` counts, in the built library, the wgmma (HGMMA), mma.sync
(HMMA) and TMA (UTMALDG, UTMASTG) instructions of the LayerNorm, GEMM and
DPT tail kernels. Each result is a JSON line; the last line is one JSON
object with every row and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import torch
import torch.nn.functional as F

from vr_video_generator_tpu_torch.stage_bench import card_line, event_ms

BF16_FLOP_PER_S = 989e12
# The f32-accurate rate: the larger of the card's f32 rate outside the
# tensor cores and 3xTF32's third of its dense TF32 rate (H100 SXM data
# sheet: 67 and 495 TFLOP/s).
F32_FLOP_PER_S = max(67e12, 495e12 / 3)
HBM_BYTES_PER_S = 3.35e12
CALLS = 50          # calls under the profiler
HOST_CALLS = 1000   # calls timed on the host clock, no sync between
HOST_SECONDS = 0.5  # ... and at most this long
LN_SHAPES = (("vits", 19544, 384), ("vitl-728", 38280, 1024),
             ("vitg-518", 19544, 1536))
# (row, label, M, D): row 9 at vitl's rows, batch 8; row 8 at 1080p/518,
# batch 8, at vits' and vitb's widths and at D = 128 (a width the kernel
# takes that no encoder has).
MLP_SHAPES = ((9, "vitl-518", 19544, 1024), (9, "vitl-728", 38280, 1024))
RESIDENT_SHAPES = ((8, "vits", 19544, 384), (8, "vitb-518", 19544, 768),
                   (8, "D=128", 19544, 128))
# Row 16 on refinenet1's 1080p/518 grid (chip_smoke's B, H0, W0): vits'
# and vitb's feature widths.
RCU_SHAPES = (("vits", 64), ("vitb", 128))
QKV_SHAPES = (("vits", 19544, 384), ("vitb-518", 19544, 768),
              ("vitl-518", 19544, 1024))
PROJ_SHAPES = QKV_SHAPES
# (label, C, (H0, W0), (H1, W1)) of the ext tail at 1080p.
EXT_TAIL_SHAPES = (("vits", 64, (148, 264), (518, 924)),
                   ("vitb", 128, (148, 264), (518, 924)),
                   ("vitl-252", 256, (72, 128), (252, 448)),
                   ("vitg-126", 384, (36, 64), (126, 224)))
SWIGLU_SHAPES = (("vitg-518", 19544),)
# (label, C, (H2, W2), (H1, W1)) of the single-kernel tail at 1080p: path1
# on vits' grid at vits' and vitb's widths.
BASE_TAIL_SHAPES = (("vits", 64, (296, 528), (518, 924)),
                    ("vitb", 128, (296, 528), (518, 924)))
# (label, C, (H0, W0), (H1, W1)) of the big-C tail at 1080p.
BIG_TAIL_SHAPES = (("vitl-518", 256, (148, 264), (518, 924)),
                   ("vitl-728", 256, (208, 368), (728, 1288)),
                   ("vitg-518", 384, (148, 264), (518, 924)))
D_G, HID_G = 1536, 4096
BATCH = 8  # row 5's rows are (8, M / 8) tokens
# The warp rows' frames: 1080p at batch 8 (both depths) and 4K at batch 2.
WARP_STRIP = 128  # blur/select's strip width, for the hole-free share


def traced(fn, calls: int) -> list:
    """The Chrome trace events of ``calls`` calls of ``fn`` under
    ``utils.profiling.trace`` (which refuses a session that lost the card's
    events), after one call outside it."""
    from vr_video_generator_tpu_torch.utils.profiling import trace

    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp, "trace.json"):
            for _ in range(calls):
                fn()
        with open(os.path.join(tmp, "trace.json"), encoding="utf-8") as f:
            return json.load(f)["traceEvents"]


def kernel_us(fn, calls: int = CALLS) -> tuple:
    """Under torch.profiler, over ``calls`` calls of ``fn``: the device time
    of each CUDA kernel it launches, in us a call, by kernel name; the mean
    span from a call's first kernel start to its last kernel end (us); and
    the host time of each CUDA runtime or driver call, in us a call, by
    name."""
    events = traced(fn, calls)
    by_name, api = defaultdict(float), defaultdict(float)
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "kernel" and "dur" in e)
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            by_name[e["name"]] += e["dur"] / calls
        elif e.get("cat") in ("cuda_runtime", "cuda_driver") and "dur" in e:
            api[e["name"]] += e["dur"] / calls
    per = len(kernels) // calls
    spans = [kernels[i + per - 1][1] - kernels[i][0]
             for i in range(0, per * calls, per)] if per else [0.0]
    return dict(by_name), sum(spans) / len(spans), dict(api)


def kernel_sequence(fn, keys, calls: int = CALLS) -> list:
    """Under torch.profiler, over ``calls`` calls of ``fn``: each kernel of
    a call whose name holds one of ``keys``, in launch order, as (name,
    device us a call), so launches of one kernel name at different places
    of a chain stay apart: the k-th launch of a name that a call launches n
    times is its (k mod n)-th place in the call."""
    kernels = sorted((e["ts"], e["name"], e["dur"])
                     for e in traced(fn, calls)
                     if e.get("cat") == "kernel" and "dur" in e
                     and any(k in e["name"] for k in keys))
    by_name = defaultdict(list)
    for _, name, dur in kernels:
        by_name[name].append(dur)
    per = {name: max(1, round(len(durs) / calls))
           for name, durs in by_name.items()}
    seen, order = defaultdict(int), []
    for _, name, _ in kernels[:sum(per.values())]:
        order.append((name, seen[name]))
        seen[name] += 1
    return [(name, sum(by_name[name][j::per[name]])
             / len(by_name[name][j::per[name]])) for name, j in order]


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host time of one call in us: ``calls`` calls back to back, no sync
    between them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def idle_host_us(fn, runs: int = 20) -> float:
    """Host time of one call on an idle device (a sync before each), in us,
    the median of ``runs``."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return sorted(times)[runs // 2]


def timings(fn) -> dict:
    """``fn``'s kernel-only (:func:`kernel_us`), event and host times. The
    host time a call is taken over at most HOST_SECONDS of calls, so that a
    row's next profile follows its first within seconds (a later session
    loses more of the card's events the later it starts, ROADMAP fault 5)."""
    kernels, span, api = kernel_us(fn)
    ms = event_ms(fn)
    calls = max(10, min(HOST_CALLS, int(HOST_SECONDS * 1e3 / ms)))
    return dict(kernel_us=sum(kernels.values()), kernels=kernels,
                span_us=span, event_ms=ms, host_us=host_us(fn, calls),
                idle_host_us=idle_host_us(fn), api_us=api)


def ln_row(label: str, m: int, d: int, f32: bool = False) -> dict:
    """Row 1 at (m, d), on bf16 rows or with ``f32`` its f32 variant
    (module docstring)."""
    from vr_video_generator_tpu_torch.ops.layernorm import (layernorm,
                                                             layernorm_plain)

    dt = torch.float32 if f32 else torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(m + d)
    x = (torch.randn(m, d, generator=gen, device="cuda") * 3 + 1).to(dt)
    w = torch.randn(d, generator=gen, device="cuda")
    b = torch.randn(d, generator=gen, device="cuda")
    wb, bb = w.to(dt), b.to(dt)
    got, want = layernorm(x, w, b), layernorm_plain(x, w, b)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    moved = 2 * x.numel() * x.element_size() + 2 * d * 4
    row = dict(row=1, label=f"{label} f32" if f32 else label, M=m, D=d,
               max_abs_err=err.max().item(),
               frac_differ=(got != want).float().mean().item(),
               bound_us=moved / HBM_BYTES_PER_S * 1e6,
               kernel=timings(lambda: layernorm(x, w, b)),
               library=timings(lambda: F.layer_norm(x, (d,), wb, bb, 1e-6)))
    for k in ("kernel", "library"):
        row[k]["bytes_share"] = row["bound_us"] / row[k]["kernel_us"]
    return row


def mlp_row(row: int, label: str, m: int, d: int) -> dict:
    """Row 8 or 9 (``mlp_residual``, ``mlp_residual_hblocked``) at (m, d)
    (module docstring)."""
    from vr_video_generator_tpu_torch.ops import mlp

    fn = {8: mlp.mlp_residual, 9: mlp.mlp_residual_hblocked}[row]
    hid = 4 * d
    randn = seeded(torch.Generator(device="cuda").manual_seed(m + d))
    f32 = torch.float32
    args = (randn((m, d)), randn((d,), 0.1, 1.0, f32), randn((d,), 0.1, 0.0, f32),
            randn((hid, d), d ** -0.5), randn((hid,), 0.5),
            randn((d, hid), hid ** -0.5), randn((d,), 0.5),
            randn((d,), 0.1, 1.0))
    got, want = fn(*args), mlp.mlp_residual_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    fc = 2 * m * d * hid  # each product
    moved = 2 * (2 * m * d + 2 * d * hid + hid + 2 * d) + 8 * d
    row = dict(row=row, label=label, M=m, D=d, hidden=hid,
               max_abs_err=err.max().item(),
               frac_differ=(got != want).float().mean().item(),
               bound_ms=max(2 * fc / BF16_FLOP_PER_S,
                            moved / HBM_BYTES_PER_S) * 1e3,
               kernel=timings(lambda: fn(*args)))
    del got, want, err
    # This tree's chain (row 1's LN, fc1 + GELU, fc2 + residual) and the
    # one wmma kernel before it.
    stages = (("ln", "layernorm_kernel", 4 * m * d, None),
              ("fc1 + GELU", "Fc1Gelu", None, fc),
              ("fc2 + residual", "LayerScaleResidual", None, fc),
              ("whole (older tree)", "mlp_kernel", None, 2 * fc))
    k = row["kernel"]
    us = stage_times(k["kernels"], [(n, key) for n, key, _, _ in stages])
    k["stages_us"] = {n: t for n, t in us.items() if t > 0}
    k["stage_rates"] = {
        n: (dict(gb_s=b / us[n] * 1e-3) if b else dict(tflops=f / us[n] * 1e-6))
        for n, _, b, f in stages if us[n] > 0}
    a, h = randn((m, d)), randn((m, hid))
    w1, w2 = args[3], args[5]
    return against_cublas(row, 2 * fc,
                          (("Fc1Gelu", fc), ("LayerScaleResidual", fc),
                           ("mlp_kernel", 2 * fc)),
                          (("cublas_fc1", lambda: F.linear(a, w1)),
                           ("cublas_fc2", lambda: F.linear(h, w2))))


def rcu_row(label: str, c: int) -> dict:
    """Row 16 at one width (module docstring)."""
    import chip_smoke
    from vr_video_generator_tpu_torch.attic.refinenet_pre import (
        refinenet_pre, refinenet_pre_plain)

    b, h0, w0 = chip_smoke.B, chip_smoke.H0, chip_smoke.W0
    gen = torch.Generator(device="cuda").manual_seed(c + 16)
    rn0, path2, ws = chip_smoke.rcu_inputs(gen, c)
    got = refinenet_pre(rn0, path2, *ws)
    want = refinenet_pre_plain(rn0, path2, *ws)
    torch.cuda.synchronize()
    conv = 2 * b * h0 * w0 * 9 * c * c  # one conv's FLOPs
    act = 2 * rn0.numel()               # one (B, H0, W0, C) bf16 tensor
    moved = 3 * act + sum(2 * t.numel() for t in ws)
    fn = lambda: refinenet_pre(rn0, path2, *ws)  # noqa: E731
    row = dict(row=16, label=label, C=c, B=b, grid=(h0, w0),
               max_abs_err=(got.float() - want.float()).abs().max().item(),
               frac_differ=(got != want).float().mean().item(),
               bound_ms=max(4 * conv / BF16_FLOP_PER_S,
                            moved / HBM_BYTES_PER_S) * 1e3,
               conv_bound_ms=conv / BF16_FLOP_PER_S * 1e3,
               kernel=timings(fn))
    del got, want
    # Each kernel of the chain in launch order (the wrapper's copies of
    # strided inputs and, on an older tree, of the weights left out): the
    # convs (this tree's GEMM core or the wmma kernel before it) by their
    # FLOPs, the ReLU pass by its bytes (one tensor read, one written).
    launches = []
    for name, us in kernel_sequence(fn, ("gemm_kernel", "rcu_conv_kernel",
                                         "relu_kernel")):
        is_conv = "relu_kernel" not in name
        launches.append(dict(
            kernel=name[:160], us=us,
            **(dict(tflops=conv / us * 1e-6) if is_conv
               else dict(gb_s=2 * act / us * 1e-3))))
    row["launches"] = launches
    k = row["kernel"]
    k["chain_us"] = sum(r["us"] for r in launches)
    k["tflops"] = 4 * conv / k["chain_us"] * 1e-6
    # cuDNN's bf16 channels-last convolution of one conv (+ bias).
    torch.backends.cudnn.allow_tf32 = False
    cl = torch.channels_last
    x = rn0.permute(0, 3, 1, 2).contiguous(memory_format=cl)
    k1 = ws[0].contiguous(memory_format=cl)
    row["cudnn_conv"] = timings(lambda: F.conv2d(x, k1, ws[1], padding=1))
    row["cudnn_conv"]["tflops"] = conv / row["cudnn_conv"]["kernel_us"] * 1e-6
    row["over_cudnn_kernel"] = k["chain_us"] / (
        4 * row["cudnn_conv"]["kernel_us"])
    row["bound_share"] = row["bound_ms"] * 1e3 / k["chain_us"]
    return row


def seeded(gen):
    """randn(shape, scale, shift, dtype) on the card from ``gen``."""
    def randn(shape, scale=1.0, shift=0.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                + shift).to(dtype)
    return randn


def against_cublas(row: dict, flops: float, stages, products) -> dict:
    """Add to ``row`` the kernel's TFLOP/s (kernel-only and by ``event_ms``),
    each stage's (a kernel whose name holds a key of ``stages``, with that
    stage's FLOPs), the cuBLAS products' timings and the kernel's time over
    theirs."""
    k = row["kernel"]
    k["tflops"] = flops / k["kernel_us"] * 1e-6
    k["event_tflops"] = flops / k["event_ms"] * 1e-9
    k["stage_tflops"] = {name: f / us * 1e-6
                         for name, us in k["kernels"].items()
                         for key, f in stages if key in name}
    for name, fn in products:
        row[name] = timings(fn)
    row["over_cublas_kernel"] = k["kernel_us"] / sum(
        row[name]["kernel_us"] for name, _ in products)
    row["over_cublas_event"] = k["event_ms"] / sum(
        row[name]["event_ms"] for name, _ in products)
    return row


def qkv_row(label: str, m: int, d: int) -> dict:
    from vr_video_generator_tpu_torch.ops.qkv import ln_qkv, ln_qkv_plain

    randn = seeded(torch.Generator(device="cuda").manual_seed(m + 5 * d))
    f32 = torch.float32
    x = randn((BATCH, m // BATCH, d))
    args = (x, randn((d,), 0.1, 1.0, f32), randn((d,), 0.1, 0.0, f32),
            randn((3 * d, d), d ** -0.5), randn((3 * d,), 0.5), d // 64,
            64 ** -0.5)
    got, want = ln_qkv(*args), ln_qkv_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    flops = 2 * m * d * 3 * d
    moved = 2 * (x.numel() + 3 * d * d + 3 * d + got.numel()) + 8 * d
    row = dict(row=5, label=label, M=m, D=d, max_abs_err=err.max().item(),
               frac_differ=(got != want).float().mean().item(),
               bound_ms=max(flops / BF16_FLOP_PER_S,
                            moved / HBM_BYTES_PER_S) * 1e3,
               kernel=timings(lambda: ln_qkv(*args)))
    del got, want, err
    a, w = randn((m, d)), args[3]
    return against_cublas(row, flops,
                          (("gemm_kernel", flops), ("dense_rows", flops)),
                          (("cublas_qkv", lambda: F.linear(a, w)),))


def proj_row(label: str, m: int, d: int) -> dict:
    from vr_video_generator_tpu_torch.ops.qkv import (proj_ls_residual,
                                                       proj_ls_residual_plain)

    randn = seeded(torch.Generator(device="cuda").manual_seed(m + 6 * d))
    n = m // BATCH
    args = (randn((BATCH, n, d // 64, 64)), randn((BATCH, n, d)),
            randn((d, d), d ** -0.5), randn((d,), 0.5), randn((d,), 0.1, 1.0))
    got, want = proj_ls_residual(*args), proj_ls_residual_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    flops = 2 * m * d * d
    moved = 2 * (3 * m * d + d * d + 2 * d)
    row = dict(row=6, label=label, M=m, D=d, max_abs_err=err.max().item(),
               frac_differ=(got != want).float().mean().item(),
               bound_ms=max(flops / BF16_FLOP_PER_S,
                            moved / HBM_BYTES_PER_S) * 1e3,
               kernel=timings(lambda: proj_ls_residual(*args)))
    del got, want, err
    o, w = args[0].reshape(m, d), args[2]
    row = against_cublas(row, flops,
                         (("gemm_kernel", flops), ("proj_kernel", flops)),
                         (("cublas_proj", lambda: F.linear(o, w)),))
    row["kernel"]["gb_s"] = moved / row["kernel"]["kernel_us"] * 1e-3
    return row


def ext_tail_row(label: str, c: int, grid, out_hw) -> dict:
    """Row 7 at one path's shapes (module docstring)."""
    from chip_smoke import tail_stats, tail_weights
    from vr_video_generator_tpu_torch.ops.head_tail import (
        head_tail_ext, head_tail_ext_plain)

    (h0, w0), (h1, w1) = grid, out_hw
    c2, hm, w2 = c // 2, 2 * h0, 2 * w0
    gen = torch.Generator(device="cuda").manual_seed(c + h0 + 7)
    randn = seeded(gen)
    x = randn((BATCH, c, h0, w0)).permute(0, 2, 3, 1)
    wts = tail_weights(gen, c)
    got = head_tail_ext(x, *wts, out_hw)
    want = head_tail_ext_plain(x, *wts, out_hw)
    torch.cuda.synchronize()
    mix = 2 * BATCH * h0 * w0 * c * c
    conv1 = 2 * BATCH * hm * w2 * 9 * c * c2
    conv2 = 2 * BATCH * h1 * w1 * 9 * c2 * 32
    xb, zb = 2 * x.numel(), 2 * BATCH * hm * w2 * c
    c1b, rb = 2 * BATCH * hm * w2 * c2, 2 * BATCH * h1 * w1 * c2
    moved = xb + sum(2 * t.numel() for t in wts) + 4 * got.numel()
    row = dict(row=7, label=label, C=c, grid=grid, out_hw=out_hw,
               **tail_stats(f"head_tail_ext {label}", got, want),
               bound_ms=max((mix + conv1 + conv2) / BF16_FLOP_PER_S,
                            moved / HBM_BYTES_PER_S) * 1e3,
               kernel=timings(lambda: head_tail_ext(x, *wts, out_hw)))
    del got, want
    # Stage rates: FLOPs of the products, bytes (each input read once, each
    # output written once) of the passes; the older tree's three kernels.
    stages = (("transpose", "to_channels_last", 2 * xb, None),
              ("mix", ("Identity", "DenseLayout"), None, mix),
              ("upsample", "upsample_kernel", xb + zb, None),
              ("conv1", "BiasBeforeCast", None, conv1),
              ("conv1", "Conv1Out", None, conv1),
              ("resize", "::resize_kernel", c1b + rb, None),
              ("conv2", "DepthOut", None, conv2),
              ("mix + W-resize (older tree)", "mix_wresize_kernel", None, mix),
              ("conv1 (older tree)", "conv1_kernel", None, conv1),
              ("conv2 (older tree)", "namespace)::conv2_kernel<", None, conv2))
    k = row["kernel"]
    us = stage_times(k["kernels"], [(n, key) for n, key, _, _ in stages])
    k["stages_us"] = {n: t for n, t in us.items() if t > 0}
    k["stage_rates"] = {
        n: (dict(gb_s=b / us[n] * 1e-3) if b else dict(tflops=f / us[n] * 1e-6))
        for n, _, b, f in stages if us[n] > 0}
    # cuDNN's bf16 channels-last convolutions of the same shapes.
    cl = torch.channels_last
    z = randn((BATCH, c, hm, w2)).contiguous(memory_format=cl)
    k1 = wts[2].contiguous(memory_format=cl)
    r = randn((BATCH, c2, h1, w1)).contiguous(memory_format=cl)
    k2 = wts[4].contiguous(memory_format=cl)
    for key, fn, flops in (
            ("cudnn_conv1", lambda: F.conv2d(z, k1, wts[3], padding=1), conv1),
            ("cudnn_conv2", lambda: F.conv2d(r, k2, padding=1), conv2)):
        row[key] = timings(fn)
        row[key]["tflops"] = flops / row[key]["kernel_us"] * 1e-6
    row["over_cudnn_kernel"] = k["kernel_us"] / (
        row["cudnn_conv1"]["kernel_us"] + row["cudnn_conv2"]["kernel_us"])
    return row


def base_tail_row(label: str, c: int, grid, out_hw) -> dict:
    """Row 15 at one path's shapes (module docstring)."""
    from chip_smoke import tail_stats, tail_weights
    from vr_video_generator_tpu_torch.ops.head_tail import (head_tail,
                                                             head_tail_plain)

    (h2, w2), (h1, w1) = grid, out_hw
    c2 = c // 2
    gen = torch.Generator(device="cuda").manual_seed(c + h2 + 15)
    randn = seeded(gen)
    x = randn((BATCH, c, h2, w2)).permute(0, 2, 3, 1)
    wts = tail_weights(gen, c)[2:]
    got = head_tail(x, *wts, out_hw)
    want = head_tail_plain(x, *wts, out_hw)
    torch.cuda.synchronize()
    conv1 = 2 * BATCH * h2 * w2 * 9 * c * c2
    conv2 = 2 * BATCH * h1 * w1 * 9 * c2 * 32
    xb, c1b, rb = 2 * x.numel(), 2 * BATCH * h2 * w2 * c2, \
        2 * BATCH * h1 * w1 * c2
    moved = xb + sum(2 * t.numel() for t in wts) + 4 * got.numel()
    row = dict(row=15, label=label, C=c, grid=grid, out_hw=out_hw,
               **tail_stats(f"head_tail {label}", got, want),
               bound_ms=max((conv1 + conv2) / BF16_FLOP_PER_S,
                            moved / HBM_BYTES_PER_S) * 1e3,
               kernel=timings(lambda: head_tail(x, *wts, out_hw)))
    del got, want
    stages = (("transpose", "to_channels_last", 2 * xb, None),
              ("conv1", "BiasBeforeCast", None, conv1),
              ("conv1", "Conv1Out", None, conv1),
              ("resize", "::resize_kernel", c1b + rb, None),
              ("conv2", "DepthOut", None, conv2),
              ("conv1 (older tree)", "conv1_kernel", None, conv1),
              ("conv2 (older tree)", "namespace)::conv2_kernel<", None, conv2))
    k = row["kernel"]
    us = stage_times(k["kernels"], [(n, key) for n, key, _, _ in stages])
    k["stages_us"] = {n: t for n, t in us.items() if t > 0}
    k["stage_rates"] = {
        n: (dict(gb_s=b / us[n] * 1e-3) if b else dict(tflops=f / us[n] * 1e-6))
        for n, _, b, f in stages if us[n] > 0}
    # cuDNN's bf16 channels-last convolutions of the same shapes.
    cl = torch.channels_last
    xc = x.permute(0, 3, 1, 2).contiguous(memory_format=cl)
    k1 = wts[0].contiguous(memory_format=cl)
    r = randn((BATCH, c2, h1, w1)).contiguous(memory_format=cl)
    k2 = wts[2].contiguous(memory_format=cl)
    for key, fn, flops in (
            ("cudnn_conv1", lambda: F.conv2d(xc, k1, wts[1], padding=1),
             conv1),
            ("cudnn_conv2", lambda: F.conv2d(r, k2, padding=1), conv2)):
        row[key] = timings(fn)
        row[key]["tflops"] = flops / row[key]["kernel_us"] * 1e-6
    row["over_cudnn_kernel"] = k["kernel_us"] / (
        row["cudnn_conv1"]["kernel_us"] + row["cudnn_conv2"]["kernel_us"])
    return row


def swiglu_row(label: str, m: int) -> dict:
    from vr_video_generator_tpu_torch.ops.mlp import (swiglu_residual,
                                                       swiglu_residual_plain)

    d, hid = D_G, HID_G
    randn = seeded(torch.Generator(device="cuda").manual_seed(m + 10))
    f32 = torch.float32
    args = (randn((m, d)), randn((d,), 0.1, 1.0, f32),
            randn((d,), 0.1, 0.0, f32), randn((2 * hid, d), d ** -0.5),
            randn((2 * hid,), 0.5), randn((d, hid), hid ** -0.5),
            randn((d,), 0.5), randn((d,), 0.1, 1.0))
    got, want = swiglu_residual(*args), swiglu_residual_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    gate, down = 2 * m * d * 2 * hid, 2 * m * hid * d
    row = dict(row=10, label=label, M=m, D=d, hidden=hid,
               max_abs_err=err.max().item(),
               frac_differ=(got != want).float().mean().item(),
               bound_ms=(gate + down) / BF16_FLOP_PER_S * 1e3,
               kernel=timings(lambda: swiglu_residual(*args)))
    del got, want, err
    h, g = randn((m, d)), randn((m, hid))
    w12, w3 = args[3], args[5]
    # This tree's gate and down GEMMs, and the wmma kernels before them.
    stages = (("SwigluGate", gate), ("gate_kernel", gate),
              ("LayerScaleResidual", down), ("down_kernel", down))
    return against_cublas(row, gate + down, stages,
                          (("cublas_gate", lambda: F.linear(h, w12)),
                           ("cublas_down", lambda: F.linear(g, w3))))


def stage_times(kernels: dict, stages) -> dict:
    """Device us a call of each stage: the kernels whose name holds its key
    (or each of a tuple of keys); stages of one label add up."""
    out = defaultdict(float)
    for label, key in stages:
        keys = (key,) if isinstance(key, str) else key
        out[label] += sum(us for name, us in kernels.items()
                          if all(k in name for k in keys))
    return dict(out)


def big_tail_rows(label: str, c: int, grid, out_hw) -> list:
    """Rows 11 and 12 at one path's shapes (module docstring)."""
    from chip_smoke import tail_stats, tail_weights
    from vr_video_generator_tpu_torch.ops.head_tail import (
        head_tail_big_back, head_tail_big_back_plain, head_tail_big_front,
        head_tail_big_front_plain)

    (h0, w0), (h1, w1) = grid, out_hw
    c2, hm, w2 = c // 2, 2 * h0, 2 * w0
    gen = torch.Generator(device="cuda").manual_seed(c + h0)
    randn = seeded(gen)
    x = randn((BATCH, c, h0, w0)).permute(0, 2, 3, 1)
    k_oc, b_oc, k1, b1, k2, b2, k3, b3 = tail_weights(gen, c)
    mid, mid_p = head_tail_big_front(x, k_oc, k1), head_tail_big_front_plain(
        x, k_oc, k1)
    torch.cuda.synchronize()
    conv1 = 2 * BATCH * hm * w2 * 9 * c * c2
    conv2 = 2 * BATCH * h1 * w1 * 9 * c2 * 32
    xb, ub = 2 * x.numel(), 2 * BATCH * hm * w2 * c
    midb, rb = 2 * mid.numel(), 2 * BATCH * h1 * w1 * c2
    front = dict(row=11, label=label, C=c, grid=grid,
                 frac_differ=(mid != mid_p).float().mean().item(),
                 bound_ms=max(conv1 / BF16_FLOP_PER_S,
                              (xb + midb) / HBM_BYTES_PER_S) * 1e3,
                 kernel=timings(lambda: head_tail_big_front(x, k_oc, k1)))
    del mid
    back_args = (k1, b_oc, b1, k2, b2, k3, b3, out_hw)
    got = head_tail_big_back(mid_p, *back_args)
    want = head_tail_big_back_plain(mid_p, *back_args)
    torch.cuda.synchronize()
    back = dict(row=12, label=label, C2=c2, out_hw=out_hw,
                **tail_stats(f"head_tail_big_back {label}", got, want),
                bound_ms=max(conv2 / BF16_FLOP_PER_S,
                             (midb + 4 * got.numel()) / HBM_BYTES_PER_S) * 1e3,
                kernel=timings(lambda: head_tail_big_back(mid_p, *back_args)))
    del got, want
    # Stage rates: FLOPs of the convs, bytes (each input read once, each
    # output written once) of the passes.
    for row, stages in (
            (front, (("transpose", "to_channels_last", 2 * xb, None),
                     ("upsample", "upsample", xb + ub, None),
                     ("conv1", "gemm_kernel", None, conv1),
                     ("whole (older tree)", "big_front_kernel", None, conv1))),
            (back, (("resize", "resize_kernel", midb + rb, None),
                    ("conv2", "conv2::conv2_kernel", None, conv2),
                    ("whole (older tree)", "big_back_kernel", None, conv2)))):
        k = row["kernel"]
        us = stage_times(k["kernels"], [(n, key) for n, key, _, _ in stages])
        k["stages_us"] = {n: t for n, t in us.items() if t > 0}
        k["stage_rates"] = {
            n: (dict(gb_s=b / us[n] * 1e-3) if b else
                dict(tflops=f / us[n] * 1e-6))
            for n, _, b, f in stages if us[n] > 0}
    # cuDNN's bf16 channels-last convolutions of the same shapes.
    cl = torch.channels_last
    u = randn((BATCH, c, hm, w2)).contiguous(memory_format=cl)
    w1c = randn((c2, c, 3, 3), (9 * c) ** -0.5).contiguous(memory_format=cl)
    r = randn((BATCH, c2, h1, w1)).contiguous(memory_format=cl)
    w2c = k2.contiguous(memory_format=cl)
    front["cudnn_conv1"] = timings(lambda: F.conv2d(u, w1c, padding=1))
    back["cudnn_conv2"] = timings(lambda: F.conv2d(r, w2c, padding=1))
    for row, key, flops in ((front, "cudnn_conv1", conv1),
                            (back, "cudnn_conv2", conv2)):
        row[key]["tflops"] = flops / row[key]["kernel_us"] * 1e-6
        row["over_cudnn_kernel"] = (row["kernel"]["kernel_us"]
                                    / row[key]["kernel_us"])
    return [front, back]


def warp_depths():
    """(label, frames, depth) of the warp rows: chip_smoke.py's ramp and a
    vits step's depth at 1080p, batch 8, each through the temporal scan,
    and a ramp at 4K, batch 2."""
    import numpy as np

    import chip_smoke
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline
    from vr_video_generator_tpu_torch.stage_bench import (
        calibrate_random_scaler)

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (chip_smoke.B, chip_smoke.H, chip_smoke.W,
                                   3), dtype=np.uint8)
    out = [("1080p ramp", frames, chip_smoke.synthetic_depth(rng, "cuda"))]
    cfg = RunConfig(encoder="vits", batch_size=chip_smoke.B,
                    compute_dtype="bfloat16", input_size=518)
    pipe = SbsPipeline.create(cfg, chip_smoke.H, chip_smoke.W,
                              allow_random=True, device="cuda", seed=0)
    calibrate_random_scaler(pipe, frames)
    with torch.inference_mode():
        depth = pipe.depth_only(pipe.frames_to_device(frames)).clone()
    out.append(("1080p vits step", frames, depth))
    del pipe
    h, w, b = 2160, 3840, 2
    ramp = np.linspace(0.0, 14.0, w, dtype=np.float32)[None, None, :]
    d4k = np.clip(ramp + rng.normal(0.0, 0.4, (b, h, w)).astype(np.float32),
                  0.0, None)
    out.append(("4K ramp", rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
                torch.from_numpy(d4k).cuda()))
    return out


def warp_rows(label: str, frames, depth, wanted) -> list:
    """Rows 3, 4, 13 and 14 (those in ``wanted``) on one depth (module
    docstring); the 4K ramp has no row 14 (134 shifts: the wrapper runs
    row 3)."""
    from chip_smoke import nbytes
    from vr_video_generator_tpu_torch import StereoConfig
    from vr_video_generator_tpu_torch.ops.temporal import (TemporalState,
                                                            temporal_scan)
    from vr_video_generator_tpu_torch.ops.warp import (
        WarpSpec, blur_select_sbs, blur_select_sbs_packed_plain,
        blur_select_sbs_plain, resolve_banded, warp_composite,
        warp_composite_banded_plain, warp_composite_plain)

    b, h, w = depth.shape
    spec = WarpSpec.create(h, w, StereoConfig(), impl="pallas",
                           device="cuda")
    imgs = torch.from_numpy(frames).cuda()
    with torch.inference_mode():
        blended, ranges, _ = temporal_scan(
            depth, TemporalState.initial(h, w, "cuda"), spec)
        _, st = spec.tables(blended, ranges)
    blended = blended.clone()
    st = type(st)(*(t.clone() for t in st))
    args = (imgs, blended, st, spec.s_neg, spec.s_pos)
    comp, cov = warp_composite(*args)
    comp_p, cov_p = warp_composite_plain(*args)
    torch.cuda.synchronize()
    kx, ky = 2 * spec.kernel_size + 3, 2 * spec.kernel_size + 1
    cols = torch.arange(w, device="cuda")
    holes = ~cov & (cols[None, None, :] >= st.edge_width[:, None, None])
    pad = (-w) % WARP_STRIP
    strips = F.pad(holes.to(torch.uint8), (0, pad)).view(b, h, -1,
                                                        WARP_STRIP).amax(-1)
    reach = F.max_pool1d(holes.permute(0, 2, 1).reshape(-1, 1, h).float(),
                         ky, stride=1, padding=ky // 2)
    data = dict(label=label, B=b, H=h, W=w, kx=kx, ky=ky,
                shifts=spec.s_neg + spec.s_pos + 1,
                live_shifts=st.valid.sum(dim=1).tolist(),
                hole_share=holes.float().mean().item(),
                uncovered_share=1.0 - cov.float().mean().item(),
                hole_free_strip_rows=1.0 - strips.float().mean().item(),
                hole_within_reach=reach.mean().item())
    print(f"warp data {json.dumps(data)}", flush=True)
    table = nbytes(*st)
    rows = []

    def row(num, name, fn, got, want, moved):
        equal = all(torch.equal(g.view(torch.uint8) if g.dtype == torch.uint32
                                else g, v.view(torch.uint8)
                                if v.dtype == torch.uint32 else v)
                    for g, v in zip(got, want))
        r = dict(row=num, kernel_name=name, label=label, equal_to_plain=equal,
                 bytes=moved, bound_ms=moved / HBM_BYTES_PER_S * 1e3,
                 kernel=timings(fn))
        k = r["kernel"]
        # The kernel itself, by name (an older tree's row 14 call also ranks
        # the shifts in PyTorch kernels).
        k["main_us"] = sum(us for n, us in k["kernels"].items()
                           if name + "_kernel" in n)
        k["gb_s"] = moved / k["main_us"] * 1e-3
        k["bound_share"] = r["bound_ms"] * 1e3 / k["main_us"]
        k["event_bound_share"] = r["bound_ms"] / k["event_ms"]
        rows.append(r)
        print(json.dumps(r), flush=True)

    if "3" in wanted:
        row(3, "warp_composite", lambda: warp_composite(*args), (comp, cov),
            (comp_p, cov_p), nbytes(imgs, blended, comp, cov) + table)
    if "14" in wanted and resolve_banded(True, spec.s_neg, spec.s_pos):
        got = warp_composite(*args, banded=True)
        want = warp_composite_banded_plain(*args)
        torch.cuda.synchronize()
        row(14, "warp_composite_banded",
            lambda: warp_composite(*args, banded=True), got + (comp, cov),
            want + (comp_p, cov_p), nbytes(imgs, blended, comp, cov) + table)
        del got, want
    bargs = (comp_p, cov_p, imgs, st.edge_width, spec.kernel_size,
             spec.cfg.sigma)
    moved_in = nbytes(comp_p, cov_p, imgs, st.edge_width)
    if "4" in wanted:
        got = blur_select_sbs(*bargs)
        want = blur_select_sbs_plain(*bargs)
        torch.cuda.synchronize()
        row(4, "blur_select_sbs", lambda: blur_select_sbs(*bargs), (got,),
            (want,), moved_in + nbytes(got))
        del got, want
    if "13" in wanted and h <= 1080:
        got = blur_select_sbs(*bargs, emit="packed")
        want = blur_select_sbs_packed_plain(*bargs)
        torch.cuda.synchronize()
        row(13, "blur_select_sbs", lambda: blur_select_sbs(*bargs,
                                                          emit="packed"),
            (got,), (want,), moved_in + nbytes(got))
        del got, want
    return rows


# The f32 rows: (row, label, M, D) of the MLP half and (row, label, C,
# (H0, W0), (H1, W1)) of the tails, at 1080p, batch 8.
F32_MLP_SHAPES = ((8, "vits", 19544, 384), (9, "vitb-518", 19544, 768),
                  (9, "vitl-518", 19544, 1024))
F32_TAIL_SHAPES = ((11, "vitb-518", 128, (148, 264), (518, 924)),
                   (7, "vitb-252", 128, (72, 128), (252, 448)))
# Rows 11 + 12 at f32 by label (f32:tail-<label>): vitb-518's C = 128, the
# CLI path that runs them; vitg-126's C = 384 (vitg's f32 fused path), and
# C = 384 at vitg-518's grid (whose f32 plans take cuDNN's tail).
F32_BIG_TAIL_SHAPES = {"vitb-518": F32_TAIL_SHAPES[0],
                       "vitg-126": (11, "vitg-126", 384, (36, 64), (126, 224)),
                       "vitg-518": (11, "vitg-518", 384, (148, 264),
                                    (518, 924))}
F32_BASE_TAIL_SHAPES = BASE_TAIL_SHAPES  # row 15: vits' and vitb's path1
# Rows 5 and 6 at f32 by label (f32:qkv-<label>): the paths that fuse the
# attention half at f32, vits' D = 384 and vitb-518's D = 768, batch 8.
F32_QKV_SHAPES = {"vits": ("vits", 19544, 384),
                  "vitb-518": ("vitb-518", 19544, 768)}
# Row 1 at f32 (f32:ln): chip_smoke.py phase 8's four shapes, vits' rows,
# vitl-728's and vitg-518's at batch 2, and vitg-518's at batch 8.
F32_LN_SHAPES = (("vits", 19544, 384, True),
                 ("vitl-728 B=2", 9570, 1024, True),
                 ("vitg-518 B=2", 4886, 1536, True),
                 ("vitg-518", 19544, 1536, True))
# Row 7 at f32 by label (f32:ext-<label>): vits' C = 64 (vits auto f32's
# tail) and vitb-252's C = 128.
F32_EXT_TAIL_SHAPES = {"vits": (7, "vits", 64, (148, 264), (518, 924)),
                       "vitb-252": F32_TAIL_SHAPES[1],
                       "c32": (7, "c32", 32, (148, 264), (518, 924))}
# Rows 16 and 15 at f32 by width (f32:rcu-<C>, f32:base-<C>).
F32_RCU_SHAPES = {str(c): (label, c) for label, c in RCU_SHAPES}
F32_BASE_BY_C = {str(s[1]): s for s in F32_BASE_TAIL_SHAPES
                 + (("c32", 32) + tuple(F32_BASE_TAIL_SHAPES[0][2:]),)}


def f32_mlp_row(row: int, label: str, m: int, d: int) -> dict:
    """Row 8 or 9 at f32 (module docstring)."""
    from vr_video_generator_tpu_torch.ops import mlp

    f32 = torch.float32
    fn = {8: mlp.mlp_residual, 9: mlp.mlp_residual_hblocked}[row]
    hid = 4 * d
    randn = seeded(torch.Generator(device="cuda").manual_seed(m + d))
    args = tuple(randn(shape, sc, sh, f32) for shape, sc, sh in (
        ((m, d), 1.0, 0.0), ((d,), 0.1, 1.0), ((d,), 0.1, 0.0),
        ((hid, d), d ** -0.5, 0.0), ((hid,), 0.5, 0.0),
        ((d, hid), hid ** -0.5, 0.0), ((d,), 0.5, 0.0), ((d,), 0.1, 1.0)))
    got, want = fn(*args), mlp.mlp_residual_plain(*args)
    torch.cuda.synchronize()
    fc = 2 * m * d * hid  # each product
    moved = 4 * (2 * m * d + 2 * d * hid + hid + 5 * d)
    row = dict(row=row, label=f"{label} f32", M=m, D=d, hidden=hid,
               max_abs_err=(got - want).abs().max().item(),
               bound_ms=max(2 * fc / F32_FLOP_PER_S,
                            moved / HBM_BYTES_PER_S) * 1e3,
               kernel=timings(lambda: fn(*args)))
    del got, want
    stages = (("ln", "layernorm", 8 * m * d, None),
              ("fc1 + GELU", "BiasGelu", None, fc),
              ("fc2 + residual", "LayerScaleResidual", None, fc))
    k = row["kernel"]
    us = stage_times(k["kernels"], [(n, key) for n, key, _, _ in stages])
    k["stages_us"] = us
    k["stage_rates"] = {
        n: (dict(gb_s=b / us[n] * 1e-3) if b else dict(tflops=f / us[n] * 1e-6))
        for n, _, b, f in stages if us[n] > 0}
    a, h = randn((m, d), dtype=f32), randn((m, hid), dtype=f32)
    w1, b1, w2, b2 = args[3], args[4], args[5], args[6]
    return against_cublas(row, 2 * fc,
                          (("BiasGelu", fc), ("LayerScaleResidual", fc)),
                          (("cublas_fc1", lambda: torch.addmm(b1, a, w1.t())),
                           ("cublas_fc2", lambda: torch.addmm(b2, h, w2.t()))))


def f32_qkv_row(label: str, m: int, d: int) -> dict:
    """Rows 5 and 6 at f32 (module docstring): one call of each, timed as a
    chain."""
    from vr_video_generator_tpu_torch.ops.qkv import (ln_qkv, ln_qkv_plain,
                                                       proj_ls_residual,
                                                       proj_ls_residual_plain)

    f32, n = torch.float32, m // BATCH
    randn = seeded(torch.Generator(device="cuda").manual_seed(m + 56 * d))
    x = randn((BATCH, n, d), dtype=f32)
    args = (x, randn((d,), 0.1, 1.0, f32), randn((d,), 0.1, 0.0, f32),
            randn((3 * d, d), d ** -0.5, dtype=f32),
            randn((3 * d,), 0.5, dtype=f32), d // 64, 64 ** -0.5)
    pargs = (randn((BATCH, n, d // 64, 64), dtype=f32), x,
             randn((d, d), d ** -0.5, dtype=f32), randn((d,), 0.5, dtype=f32),
             randn((d,), 0.1, 1.0, f32))
    errs = dict(
        qkv_max_abs_err=(ln_qkv(*args) - ln_qkv_plain(*args)).abs().max()
        .item(),
        proj_max_abs_err=(proj_ls_residual(*pargs)
                          - proj_ls_residual_plain(*pargs)).abs().max().item())
    qkv, proj = 2 * m * d * 3 * d, 2 * m * d * d
    moved = 4 * (m * d + 3 * d * d + 3 * d + 3 * m * d + 2 * d) \
        + 4 * (3 * m * d + d * d + 2 * d)
    row = dict(row="5+6", label=f"{label} f32", M=m, D=d, **errs,
               bound_ms=max((qkv + proj) / F32_FLOP_PER_S,
                            moved / HBM_BYTES_PER_S) * 1e3,
               kernel=timings(lambda: (ln_qkv(*args),
                                       proj_ls_residual(*pargs))))
    # The stages by kernel name: the 3xTF32 core's epilogues, or an older
    # tree's SIMT ones (QkvF32; sgemm's LayerScaleResidual).
    stages = (("ln", "layernorm", 8 * m * d, None, None),
              ("qkv + bias, q scale", ("QkvScale", "QkvF32"), None, qkv,
               qkv / F32_FLOP_PER_S),
              ("proj + residual", ("LayerScaleResidual",), None, proj,
               proj / F32_FLOP_PER_S))
    k = row["kernel"]
    us = stage_times(k["kernels"], [(name, key) for name, keys, _, _, _ in
                                    stages for key in
                                    ((keys,) if isinstance(keys, str)
                                     else keys)])
    k["stages_us"] = us
    k["stage_rates"] = {
        name: (dict(gb_s=b / us[name] * 1e-3) if b
               else dict(tflops=f / us[name] * 1e-6,
                         bound_share=t * 1e6 / us[name]))
        for name, _, b, f, t in stages if us.get(name, 0) > 0}
    a2 = randn((m, d), dtype=f32)
    o2 = pargs[0].reshape(m, d)
    w, b, wp, bp = args[3], args[4], pargs[2], pargs[3]
    row["cublas_qkv"] = timings(lambda: torch.addmm(b, a2, w.t()))
    row["cublas_proj"] = timings(lambda: torch.addmm(bp, o2, wp.t()))
    for key, stage, f in (("cublas_qkv", "qkv + bias, q scale", qkv),
                          ("cublas_proj", "proj + residual", proj)):
        row[key]["tflops"] = f / row[key]["kernel_us"] * 1e-6
        row[f"{key}_over"] = us.get(stage, 0.0) / row[key]["kernel_us"]
    row["bound_share"] = row["bound_ms"] * 1e3 / k["kernel_us"]
    return row


def f32_tail_row(row: int, label: str, c: int, grid, out_hw) -> dict:
    """Rows 11 + 12 (``row`` 11) or row 7 at f32 (module docstring)."""
    from chip_smoke import f32_tail_weights
    from vr_video_generator_tpu_torch.ops import head_tail as ht

    (h0, w0), (h1, w1) = grid, out_hw
    c2, hm, w2 = c // 2, 2 * h0, 2 * w0
    gen = torch.Generator(device="cuda").manual_seed(c + h0)
    x = seeded(gen)((BATCH, c, h0, w0), dtype=torch.float32).permute(
        0, 2, 3, 1)
    wts = f32_tail_weights(gen, c)
    fn, plain = ((ht.head_tail_big, ht.head_tail_big_plain) if row == 11
                 else (ht.head_tail_ext, ht.head_tail_ext_plain))
    got, want = fn(x, *wts, out_hw), plain(x, *wts, out_hw)
    torch.cuda.synchronize()
    m0, m1, m2 = BATCH * h0 * w0, BATCH * hm * w2, BATCH * h1 * w1
    mix = 2 * m0 * c * c if row == 7 else 0
    conv1, conv2 = 2 * m1 * 9 * c * c2, 2 * m2 * 9 * c2 * 32
    xb, ub, midb, rb = 4 * x.numel(), 4 * m1 * c, 4 * m1 * c2, 4 * m2 * c2
    span = (want.max() - want.min()).item()
    res = dict(row=f"{row}" if row == 7 else "11+12", label=f"{label} f32",
               C=c, grid=grid, out_hw=out_hw,
               max_rel_err=(got - want).abs().max().item() / span,
               bound_ms=max((mix + conv1 + conv2) / F32_FLOP_PER_S,
                            (xb + 4 * got.numel()) / HBM_BYTES_PER_S) * 1e3,
               kernel=timings(lambda: fn(x, *wts, out_hw)))
    del got, want
    # Stages by kernel name: the passes by name, the products by their
    # kernel and epilogue: conv2 DepthOut, conv1 the SIMT core's implicit
    # GEMM (Conv3x3Rows) or the 3xTF32 core's conv_kernel, the mix the SIMT
    # core's dense product (an older tree's row 7) or the 3xTF32 core's
    # gemm_kernel.
    def stage(name: str) -> str:
        for key, st in (("to_channels_last", "transpose"),
                        ("upsample", "upsample"), ("resize_kernel", "resize"),
                        ("DepthOut", "conv2"), ("Conv3x3Rows", "conv1"),
                        ("conv_kernel", "conv1"), ("gemm_kernel", "mix")):
            if key in name:
                return st
        return "other"

    stages = (("transpose", 2 * xb, None), ("mix", None, mix),
              ("upsample", xb + ub, None), ("conv1", None, conv1),
              ("resize", midb + rb, None), ("conv2", None, conv2))
    k = res["kernel"]
    by_stage = defaultdict(float)
    for name, t in k["kernels"].items():
        by_stage[stage(name)] += t
    us = {n: by_stage[n] for n, _, _ in stages}
    k["stages_us"] = {n: t for n, t in us.items() if t > 0}
    k["stage_rates"] = {
        n: (dict(gb_s=b / us[n] * 1e-3) if b else dict(tflops=f / us[n] * 1e-6))
        for n, b, f in stages if us[n] > 0}
    u = seeded(gen)((BATCH, c, hm, w2), dtype=torch.float32).contiguous(
        memory_format=torch.channels_last)
    r = seeded(gen)((BATCH, c2, h1, w1), dtype=torch.float32).contiguous(
        memory_format=torch.channels_last)
    k1, k2 = wts[2], wts[4]
    res["cudnn_convs"] = timings(lambda: (F.conv2d(u, k1, padding=1),
                                          F.conv2d(r, k2, padding=1)))
    res["cudnn_convs"]["tflops"] = ((conv1 + conv2)
                                    / res["cudnn_convs"]["kernel_us"] * 1e-6)
    res["over_cudnn_kernel"] = k["kernel_us"] / res["cudnn_convs"]["kernel_us"]
    res["bound_share"] = res["bound_ms"] * 1e3 / k["kernel_us"]
    return res


def f32_swiglu_row(label: str, m: int) -> dict:
    """Row 10 at f32 (module docstring)."""
    from vr_video_generator_tpu_torch.ops.mlp import (swiglu_residual,
                                                       swiglu_residual_plain)

    d, hid, f32 = D_G, HID_G, torch.float32
    randn = seeded(torch.Generator(device="cuda").manual_seed(m + 10))
    args = tuple(randn(shape, sc, sh, f32) for shape, sc, sh in (
        ((m, d), 1.0, 0.0), ((d,), 0.1, 1.0), ((d,), 0.1, 0.0),
        ((2 * hid, d), d ** -0.5, 0.0), ((2 * hid,), 0.5, 0.0),
        ((d, hid), hid ** -0.5, 0.0), ((d,), 0.5, 0.0), ((d,), 0.1, 1.0)))
    got, want = swiglu_residual(*args), swiglu_residual_plain(*args)
    torch.cuda.synchronize()
    gate, down = 2 * m * d * 2 * hid, 2 * m * hid * d
    moved = 4 * (2 * m * d + 3 * d * hid + 2 * hid + 5 * d)
    row = dict(row=10, label=f"{label} f32", M=m, D=d, hidden=hid,
               max_abs_err=(got - want).abs().max().item(),
               bound_ms=max((gate + down) / F32_FLOP_PER_S,
                            moved / HBM_BYTES_PER_S) * 1e3,
               kernel=timings(lambda: swiglu_residual(*args)))
    del got, want
    k = row["kernel"]
    k["stages_us"] = stage_times(k["kernels"], (
        ("ln", "layernorm"), ("gate + silu", "SwigluGate"),
        ("down + residual", "LayerScaleResidual")))
    h, g = randn((m, d), dtype=f32), randn((m, hid), dtype=f32)
    w12, b12, w3, b3 = args[3], args[4], args[5], args[6]
    return against_cublas(row, gate + down,
                          (("SwigluGate", gate), ("LayerScaleResidual", down)),
                          (("cublas_gate", lambda: torch.addmm(b12, h,
                                                               w12.t())),
                           ("cublas_down", lambda: torch.addmm(b3, g,
                                                               w3.t()))))


def f32_base_tail_row(label: str, c: int, grid, out_hw) -> dict:
    """Row 15 at f32 (module docstring)."""
    from chip_smoke import f32_tail_weights
    from vr_video_generator_tpu_torch.ops.head_tail import (head_tail,
                                                             head_tail_plain)

    (h2, w2), (h1, w1) = grid, out_hw
    c2, f32 = c // 2, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(c + h2 + 15)
    randn = seeded(gen)
    x = randn((BATCH, c, h2, w2), dtype=f32).permute(0, 2, 3, 1)
    wts = f32_tail_weights(gen, c)[2:]
    got, want = head_tail(x, *wts, out_hw), head_tail_plain(x, *wts, out_hw)
    torch.cuda.synchronize()
    conv1 = 2 * BATCH * h2 * w2 * 9 * c * c2
    conv2 = 2 * BATCH * h1 * w1 * 9 * c2 * 32
    xb, c1b, rb = 4 * x.numel(), 4 * BATCH * h2 * w2 * c2, \
        4 * BATCH * h1 * w1 * c2
    moved = xb + sum(4 * t.numel() for t in wts) + 4 * got.numel()
    span = (want.max() - want.min()).item()
    row = dict(row=15, label=f"{label} f32", C=c, grid=grid, out_hw=out_hw,
               max_rel_err=(got - want).abs().max().item() / span,
               bound_ms=max((conv1 + conv2) / F32_FLOP_PER_S,
                            moved / HBM_BYTES_PER_S) * 1e3,
               kernel=timings(lambda: head_tail(x, *wts, out_hw)))
    del got, want
    stages = (("transpose", "to_channels_last", 2 * xb, None),
              ("conv1", "BiasStore", None, conv1),
              ("resize", "resize_kernel", c1b + rb, None),
              ("conv2", "DepthOut", None, conv2))
    k = row["kernel"]
    us = stage_times(k["kernels"], [(n, key) for n, key, _, _ in stages])
    k["stages_us"] = {n: t for n, t in us.items() if t > 0}
    k["stage_rates"] = {
        n: (dict(gb_s=b / us[n] * 1e-3) if b else dict(tflops=f / us[n] * 1e-6))
        for n, _, b, f in stages if us[n] > 0}
    xc = x.permute(0, 3, 1, 2)
    r = randn((BATCH, c2, h1, w1), dtype=f32).contiguous(
        memory_format=torch.channels_last)
    k1, b1, k2 = wts[0], wts[1], wts[2]
    row["cudnn_convs"] = timings(lambda: (F.conv2d(xc, k1, b1, padding=1),
                                          F.conv2d(r, k2, padding=1)))
    row["cudnn_convs"]["tflops"] = ((conv1 + conv2)
                                    / row["cudnn_convs"]["kernel_us"] * 1e-6)
    row["over_cudnn_kernel"] = k["kernel_us"] / row["cudnn_convs"]["kernel_us"]
    row["bound_share"] = row["bound_ms"] * 1e3 / k["kernel_us"]
    return row


def f32_rcu_row(label: str, c: int) -> dict:
    """Row 16 at f32 (module docstring)."""
    import chip_smoke
    from vr_video_generator_tpu_torch.attic.refinenet_pre import (
        refinenet_pre, refinenet_pre_plain)

    b, h0, w0 = chip_smoke.B, chip_smoke.H0, chip_smoke.W0
    gen = torch.Generator(device="cuda").manual_seed(c + 16)
    rn0, path2, ws = (t.float() if not isinstance(t, list)
                      else [w.float() for w in t]
                      for t in chip_smoke.rcu_inputs(gen, c))
    got = refinenet_pre(rn0, path2, *ws)
    want = refinenet_pre_plain(rn0, path2, *ws)
    torch.cuda.synchronize()
    conv = 2 * b * h0 * w0 * 9 * c * c  # one conv's FLOPs
    act = 4 * rn0.numel()               # one (B, H0, W0, C) f32 tensor
    moved = 3 * act + sum(4 * t.numel() for t in ws)
    fn = lambda: refinenet_pre(rn0, path2, *ws)  # noqa: E731
    row = dict(row=16, label=f"{label} f32", C=c, B=b, grid=(h0, w0),
               max_abs_err=(got - want).abs().max().item(),
               bound_ms=max(4 * conv / F32_FLOP_PER_S,
                            moved / HBM_BYTES_PER_S) * 1e3,
               conv_bound_ms=conv / F32_FLOP_PER_S * 1e3,
               kernel=timings(fn))
    del got, want
    launches = []
    for name, us in kernel_sequence(fn, ("sgemm_kernel", "conv_kernel",
                                         "relu_kernel")):
        is_conv = "relu_kernel" not in name
        launches.append(dict(
            kernel=name[:160], us=us,
            **(dict(tflops=conv / us * 1e-6) if is_conv
               else dict(gb_s=2 * act / us * 1e-3))))
    row["launches"] = launches
    k = row["kernel"]
    k["chain_us"] = sum(r["us"] for r in launches)
    k["tflops"] = 4 * conv / k["chain_us"] * 1e-6
    x = rn0.permute(0, 3, 1, 2)
    row["cudnn_conv"] = timings(lambda: F.conv2d(x, ws[0], ws[1], padding=1))
    row["cudnn_conv"]["tflops"] = conv / row["cudnn_conv"]["kernel_us"] * 1e-6
    row["over_cudnn_kernel"] = k["chain_us"] / (
        4 * row["cudnn_conv"]["kernel_us"])
    row["bound_share"] = row["bound_ms"] * 1e3 / k["chain_us"]
    return row


def sass_counts() -> dict:
    """wgmma, mma.sync and TMA instructions of the LayerNorm, GEMM, conv and
    big-C tail kernels in the built library (cuobjdump -sass)."""
    from vr_video_generator_tpu_torch.attention_bench import sass_counts as sc

    return sc(("layernorm", "gemm_kernel", "head_tail_big", "conv2_kernel",
               "proj_kernel", "mix_wresize", "conv1_kernel", "split_kernel",
               "conv_kernel"))


def job(name: str, args: tuple) -> list:
    """The rows of one measurement (a function of this module on its
    arguments), with the numeric settings of every row: TF32 and cuBLAS's
    reduced-precision bf16 sums off. Run in a fresh process
    (utils.profiling.in_fresh_process), so that its kernel-only times come
    from that process's first profile (ROADMAP fault 5)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    out = globals()[name](*args)
    return out if isinstance(out, list) else [out]


def warp_group(wanted) -> list:
    """Rows 3, 4, 13 and 14 (those in ``wanted``) on each of
    :func:`warp_depths`."""
    rows = []
    for label, frames, depth in warp_depths():
        rows.extend(warp_rows(label, frames, depth, wanted))
        del frames, depth
        torch.cuda.empty_cache()
    return rows


def jobs(wanted) -> list:
    """(function name, arguments) of each measurement ``--rows`` asks for,
    in order."""
    out = []
    for key, name, shapes in (("1", "ln_row", LN_SHAPES),
                              ("5", "qkv_row", QKV_SHAPES),
                              ("6", "proj_row", PROJ_SHAPES),
                              ("7", "ext_tail_row", EXT_TAIL_SHAPES),
                              ("15", "base_tail_row", BASE_TAIL_SHAPES),
                              ("8", "mlp_row", RESIDENT_SHAPES),
                              ("16", "rcu_row", RCU_SHAPES),
                              ("9", "mlp_row", MLP_SHAPES),
                              ("10", "swiglu_row", SWIGLU_SHAPES)):
        if key in wanted:
            out += [(name, shape) for shape in shapes]
    if wanted & {"11", "12"}:
        out += [("big_tail_rows", shape) for shape in BIG_TAIL_SHAPES]
    every = "f32" in wanted  # else only the f32:<label> rows
    labels = {w.split(":", 1)[1] for w in wanted if w.startswith("f32:")}

    def picked(prefix: str, table: dict) -> list:
        return [table[k.split("-", 1)[1]] for k in sorted(labels)
                if k.startswith(prefix + "-")]

    tails = picked("tail", F32_BIG_TAIL_SHAPES) + picked("ext",
                                                        F32_EXT_TAIL_SHAPES)
    for name, shapes in (
            ("ln_row", F32_LN_SHAPES if every or "ln" in labels else ()),
            ("f32_qkv_row", list(F32_QKV_SHAPES.values()) if every
             else picked("qkv", F32_QKV_SHAPES)),
            ("f32_mlp_row", [s for s in F32_MLP_SHAPES
                             if every or s[1] in labels]),
            ("f32_swiglu_row", [s for s in SWIGLU_SHAPES
                                if every or s[0] in labels]),
            ("f32_tail_row", F32_TAIL_SHAPES if every else tails),
            ("f32_base_tail_row", F32_BASE_TAIL_SHAPES if every
             else picked("base", F32_BASE_BY_C)),
            ("f32_rcu_row", RCU_SHAPES if every
             else picked("rcu", F32_RCU_SHAPES))):
        out += [(name, shape) for shape in shapes]
    if wanted & {"3", "4", "13", "14"}:
        out.append(("warp_group", (sorted(wanted),)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sass", action="store_true",
                    help="count wgmma/TMA instructions in the built kernels")
    ap.add_argument("--rows", default="1,5,6,7,9,10,11,12",
                    help="which rows to measure (comma-separated: 1, 3, 4, "
                    "5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16; 11 and 12 "
                    "are measured together; f32: rows 1 and 5-12, 15 "
                    "and 16 at f32; f32:ln row 1 at f32; f32:qkv-<label> "
                    "rows 5 and 6 at f32, label vits or vitb-518; "
                    "f32:<label> one f32 row of rows 8-10, "
                    "f32:tail-<label> rows 11 + 12 at f32, label vitb-518, "
                    "vitg-126 or vitg-518; f32:ext-<label> row 7 at f32, "
                    "label vits, vitb-252 or c32; f32:rcu-<C> row 16 at "
                    "f32, f32:base-<C> row 15 at f32, C 32, 64 or 128)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemm_bench: no CUDA device", file=sys.stderr)
        return 2
    from vr_video_generator_tpu_torch.kernels.build import build
    from vr_video_generator_tpu_torch.utils.profiling import in_fresh_process

    card = card_line()
    print(card, flush=True)
    out = dict(card=card)
    build()  # once, before the measurements' processes load it
    if opts.sass:
        out["sass"] = sass_counts()
        print(f"sass: {json.dumps(out['sass'])}", flush=True)
    rows = []
    for name, args in jobs(set(opts.rows.split(","))):
        for row in in_fresh_process(job, name, args):
            rows.append(row)
            print(json.dumps(row), flush=True)
    out["rows"] = rows
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
