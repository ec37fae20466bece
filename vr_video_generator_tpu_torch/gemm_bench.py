"""Check and time the LayerNorm kernel (row 1) and the hidden-blocked MLP
half (row 9) on the card at the shapes the main paths give them.

    python3 -m vr_video_generator_tpu_torch.gemm_bench [--sass] [--rows 1,9]

Row 1 at 1080p, batch 8: (19544, 384) (vits), (38280, 1024) (vitl-728),
(19544, 1536) (vitg-518). For the kernel and for one ``F.layer_norm`` call
(never called by the port) on the same seeded rows: the kernel-only device
time (``torch.profiler``, CUDA kernel events, mean over ``CALLS`` calls),
``event_ms`` (CUDA events around one call, median of 20: the host's launch
is inside it), the host time a call (``HOST_CALLS`` calls without a sync,
and one call on an idle device), and the error against the plain version.

Row 9 at M = 19544 (vitl-518, batch 8) and 38280 (vitl-728, batch 8): the
device time of each kernel of the call and the span from the first kernel's
start to the last one's end (profiler), the host time of each CUDA API call
it makes, the call's TFLOP/s and ``event_ms``, the error against
``mlp_residual_plain``, and as a yardstick
(no PyTorch call computes the same function) the two cuBLAS products of the
same shapes, ``F.linear`` (M, 1024) x (4096, 1024) and (M, 4096) x (1024,
4096), timed the same ways. ``--sass`` counts, in the built library, the
wgmma (HGMMA) and TMA (UTMALDG, UTMASTG) instructions of the LayerNorm and
GEMM kernels. Each result is a JSON line; the last line is one JSON object
with every row and the card's name and power limit.
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
HBM_BYTES_PER_S = 3.35e12
CALLS = 50          # calls under the profiler
HOST_CALLS = 1000   # calls timed on the host clock, no sync between
LN_SHAPES = (("vits", 19544, 384), ("vitl-728", 38280, 1024),
             ("vitg-518", 19544, 1536))
MLP_SHAPES = (("vitl-518", 19544), ("vitl-728", 38280))
D_L = 1024


def kernel_us(fn, calls: int = CALLS) -> tuple:
    """Under torch.profiler, over ``calls`` calls of ``fn``: the device time
    of each CUDA kernel it launches, in us a call, by kernel name; the mean
    span from a call's first kernel start to its last kernel end (us); and
    the host time of each CUDA runtime or driver call, in us a call, by
    name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
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
    kernels, span, api = kernel_us(fn)
    return dict(kernel_us=sum(kernels.values()), kernels=kernels,
                span_us=span, event_ms=event_ms(fn), host_us=host_us(fn),
                idle_host_us=idle_host_us(fn), api_us=api)


def ln_row(label: str, m: int, d: int) -> dict:
    from vr_video_generator_tpu_torch.ops.layernorm import (layernorm,
                                                             layernorm_plain)

    gen = torch.Generator(device="cuda").manual_seed(m + d)
    x = (torch.randn(m, d, generator=gen, device="cuda") * 3 + 1).to(
        torch.bfloat16)
    w = torch.randn(d, generator=gen, device="cuda")
    b = torch.randn(d, generator=gen, device="cuda")
    wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
    got, want = layernorm(x, w, b), layernorm_plain(x, w, b)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    moved = 2 * x.numel() * x.element_size() + 2 * d * 4
    row = dict(row=1, label=label, M=m, D=d, max_abs_err=err.max().item(),
               frac_differ=(got != want).float().mean().item(),
               bound_us=moved / HBM_BYTES_PER_S * 1e6,
               kernel=timings(lambda: layernorm(x, w, b)),
               library=timings(lambda: F.layer_norm(x, (d,), wb, bb, 1e-6)))
    for k in ("kernel", "library"):
        row[k]["bytes_share"] = row["bound_us"] / row[k]["kernel_us"]
    return row


def mlp_row(label: str, m: int) -> dict:
    from vr_video_generator_tpu_torch.ops.mlp import (mlp_residual_hblocked,
                                                       mlp_residual_plain)

    d, hid = D_L, 4 * D_L
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(m)

    def randn(shape, scale=1.0, shift=0.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                + shift).to(dtype)

    f32 = torch.float32
    args = (randn((m, d)), randn((d,), 0.1, 1.0, f32), randn((d,), 0.1, 0.0, f32),
            randn((hid, d), d ** -0.5), randn((hid,), 0.5),
            randn((d, hid), hid ** -0.5), randn((d,), 0.5),
            randn((d,), 0.1, 1.0))
    got, want = mlp_residual_hblocked(*args), mlp_residual_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    flops = 2 * 2 * m * d * hid
    row = dict(row=9, label=label, M=m, D=d, hidden=hid,
               max_abs_err=err.max().item(),
               frac_differ=(got != want).float().mean().item(),
               bound_ms=flops / BF16_FLOP_PER_S * 1e3,
               kernel=timings(lambda: mlp_residual_hblocked(*args)))
    del got, want
    a, h = randn((m, d)), randn((m, hid))
    w1, w2 = args[3], args[5]
    row["cublas_fc1"] = timings(lambda: F.linear(a, w1))
    row["cublas_fc2"] = timings(lambda: F.linear(h, w2))
    k = row["kernel"]
    k["tflops"] = flops / k["kernel_us"] * 1e-6
    k["event_tflops"] = flops / k["event_ms"] * 1e-9
    for name, us in k["kernels"].items():
        # Each GEMM stage is half the FLOPs.
        if "gemm" in name or "mlp_kernel" in name:
            k.setdefault("stage_tflops", {})[name] = (
                flops / (2 if "gemm" in name else 1) / us * 1e-6)
    cublas_us = row["cublas_fc1"]["kernel_us"] + row["cublas_fc2"]["kernel_us"]
    cublas_ms = row["cublas_fc1"]["event_ms"] + row["cublas_fc2"]["event_ms"]
    row["over_cublas_kernel"] = k["kernel_us"] / cublas_us
    row["over_cublas_event"] = k["event_ms"] / cublas_ms
    return row


def sass_counts() -> dict:
    """wgmma and TMA instructions of the LayerNorm and GEMM kernels in the
    built library (cuobjdump -sass)."""
    from vr_video_generator_tpu_torch.attention_bench import sass_counts as sc

    return sc(("layernorm", "gemm_kernel"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sass", action="store_true",
                    help="count wgmma/TMA instructions in the built kernels")
    ap.add_argument("--rows", default="1,9",
                    help="which rows to measure (comma-separated: 1, 9)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemm_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    print(card, flush=True)
    out = dict(card=card)
    if opts.sass:
        out["sass"] = sass_counts()
        print(f"sass: {json.dumps(out['sass'])}", flush=True)
    rows = []
    wanted = set(opts.rows.split(","))
    if "1" in wanted:
        for shape in LN_SHAPES:
            rows.append(ln_row(*shape))
            print(json.dumps(rows[-1]), flush=True)
    if "9" in wanted:
        for shape in MLP_SHAPES:
            rows.append(mlp_row(*shape))
            print(json.dumps(rows[-1]), flush=True)
            torch.cuda.empty_cache()
    out["rows"] = rows
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
