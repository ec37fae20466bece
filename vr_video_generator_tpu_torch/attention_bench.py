"""Check and time the attention kernels (rows 2 and 17) on the card at the
shapes the main paths give them.

    python3 -m vr_video_generator_tpu_torch.attention_bench [--sass]

For each shape (1080p, --input_size 518: N = 2443 tokens at vits' 6 heads,
vitl's 16 and vitg's 24, batch 8; --input_size 728: N = 4785 at vitl's 16
heads, batch 2 as ``chip_smoke.py`` runs it and batch 8 as ``stage_bench``
does; and at 1 and 2 heads, batch 8, at both token counts: a model-group
rank's share of vits' or vitb's heads) it runs the kernel and its plain version on the same seeded q/k/v,
with k and v strided views into one qkv as the fused path passes them, and
prints one JSON line: the error against the plain version (max and mean,
absolute and against max / mean |o|), the CUDA-event median times of the
kernel, the plain version and one ``scaled_dot_product_attention`` call
(never called by the port), the kernel's TFLOP/s and the least time the
card could take (the bf16 tensor-core FLOPs at 989 TFLOP/s).

The f32 rows (``--compute_dtype float32``: ``csrc/attention_f32.cu``) run at
chip_smoke.py phase 8's three shapes (row 2 at vits' 6 heads and vitg-518's
24, row 17 at vitl-728, B = 2) on f32 q/k/v, TF32 off, beside one f32
``scaled_dot_product_attention`` call: the errors of both against the plain
version, the times, the TFLOP/s and the bound at the f32-accurate rate
(``F32_FLOP_PER_S``, 3xTF32 on the tensor cores). Their kernel-only times
come from the process's first ``torch.profiler`` session (a later session
can lose device events), which runs every f32 shape in turn, ``PROFILED``
calls of the kernel (its split pass and its attention kernel) and one SDPA
call each, and must hold exactly the expected number of the port's kernel
events; SDPA's kernel names are read from the same trace.

``--sass`` also counts, in the built library, the wgmma (HGMMA, and those
with TF32 operands) and TMA (UTMALDG, UTMASTG) instructions of each
attention kernel. The last line is one JSON object with every row and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F

from vr_video_generator_tpu_torch.gemm_bench import F32_FLOP_PER_S
from vr_video_generator_tpu_torch.kernels import launch_counts
from vr_video_generator_tpu_torch.ops import attention as A
from vr_video_generator_tpu_torch.stage_bench import card_line, event_ms

BF16_FLOP_PER_S = 989e12
SHAPES = (  # (label, kernel, B, N, H)
    ("row 2 vits", "attention", 8, 2443, 6),
    ("row 2 vitl-518", "attention", 8, 2443, 16),
    ("row 2 vitg-518", "attention", 8, 2443, 24),
    ("row 17 vitl-728 B=2", "flash_attention", 2, 4785, 16),
    ("row 17 vitl-728 B=8", "flash_attention", 8, 4785, 16),
    # A model-group rank's heads where M does not divide them (vits' 6 at
    # M = 4, vitb's 12 at M = 8: 1 or 2 a rank).
    ("row 2 rank H=1", "attention", 8, 2443, 1),
    ("row 2 rank H=2", "attention", 8, 2443, 2),
    ("row 17 rank H=1", "flash_attention", 8, 4785, 1),
    ("row 17 rank H=2", "flash_attention", 8, 4785, 2),
)
F32_SHAPES = (  # chip_smoke.py phase 8's
    ("row 2 vits f32", "attention", 8, 2443, 6),
    ("row 2 vitg-518 f32", "attention", 8, 2443, 24),
    ("row 17 vitl-728 B=2 f32", "flash_attention", 2, 4785, 16),
)
SCALE = 64 ** -0.5
PROFILED = 5  # kernel calls a shape in the f32 profile
F32_KERNELS = ("split_kv_kernel", "attention_f32_kernel")


def peaked_qkv(gen, b, n, heads, dtype=torch.bfloat16, head_dim=64):
    """(B, N, 3, H, Dh) q/k/v with a peaked softmax: the other logits have
    std ~1.5, and head dim 0 adds the same -4 (after the Dh^-0.5 scale) to
    every logit, so the softmax over the real keys is unchanged but a key at
    or past N that a kernel failed to mask (logit 0) would weigh as much as
    e^4 real keys."""
    qkv = torch.randn(b, n, 3, heads, head_dim, generator=gen,
                      device=gen.device)
    qkv[:, :, 1] *= 1.5
    qkv[:, :, 0, :, 0] = 4.0
    qkv[:, :, 1, :, 0] = -head_dim ** 0.5
    return qkv.to(dtype)


def error_stats(got, want) -> dict:
    """Max and mean |got - want|, absolute and against max / mean |want|."""
    err = (got.float() - want.float()).abs()
    size = want.float().abs()
    return dict(max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
                max_rel_err=(err.max() / size.max()).item(),
                mean_rel_err=(err.mean() / size.mean()).item())


def attention_case(kernel: str, b: int, n: int, heads: int, seed: int = 0,
                   dtype=torch.bfloat16):
    """The inputs and calls of one shape: (args, kernel fn, plain fn, SDPA
    fn). Row 2 takes q pre-scaled as ``mha`` passes it; row 17 q unscaled,
    as a view into the same qkv."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = peaked_qkv(gen, b, n, heads, dtype)
    k, v = qkv[:, :, 1], qkv[:, :, 2]
    if kernel == "attention":
        q = (qkv[:, :, 0].float() * SCALE).to(dtype)
        fn, plain, sdpa_scale = A.attention, A.attention_plain, 1.0
        args = (q, k, v)
    else:
        q = qkv[:, :, 0]
        fn = A.flash_attention
        plain, sdpa_scale = A.flash_attention_plain, SCALE
        args = (q, k, v, SCALE)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return (args, fn, plain,
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   scale=sdpa_scale))


def measure(label: str, kernel: str, b: int, n: int, heads: int) -> dict:
    args, fn, plain, sdpa = attention_case(kernel, b, n, heads)
    before = launch_counts().get(kernel, 0)
    got = fn(*args)
    torch.cuda.synchronize()
    launched = launch_counts()[kernel] - before
    stats = error_stats(got, plain(*args))
    del got
    flops = 4 * b * heads * n * n * 64
    ms = event_ms(lambda: fn(*args))
    row = dict(label=label, kernel=kernel, B=b, N=n, H=heads,
               launches=launched, **stats, ms=ms,
               plain_ms=event_ms(lambda: plain(*args)),
               library_ms=event_ms(sdpa),
               bound_ms=flops / BF16_FLOP_PER_S * 1e3)
    row["tflops"] = flops / ms * 1e-9
    row["library_tflops"] = flops / row["library_ms"] * 1e-9
    row["over_library"] = ms / row["library_ms"]
    return row


def measure_f32(label: str, kernel: str, b: int, n: int, heads: int) -> dict:
    """One f32 shape, TF32 off: the kernel's and SDPA's errors against the
    plain version, their times, and the bound at ``F32_FLOP_PER_S``."""
    from vr_video_generator_tpu_torch.models.depth_anything_v2 import no_tf32

    with no_tf32():
        args, fn, plain, sdpa = attention_case(kernel, b, n, heads,
                                               dtype=torch.float32)
        counter = kernel + "_f32"
        before = launch_counts().get(counter, 0)
        got = fn(*args)
        torch.cuda.synchronize()
        launched = launch_counts()[counter] - before
        want = plain(*args)
        stats = error_stats(got, want)
        lib = sdpa().transpose(1, 2)
        sdpa_stats = {f"library_{k}": x
                      for k, x in error_stats(lib, want).items()}
        del got, want, lib
        flops = 4 * b * heads * n * n * 64
        ms = event_ms(lambda: fn(*args))
        row = dict(label=label, kernel=counter, B=b, N=n, H=heads,
                   launches=launched, **stats, **sdpa_stats, ms=ms,
                   plain_ms=event_ms(lambda: plain(*args)),
                   library_ms=event_ms(sdpa),
                   bound_ms=flops / F32_FLOP_PER_S * 1e3)
    row["tflops"] = flops / ms * 1e-9
    row["library_tflops"] = flops / row["library_ms"] * 1e-9
    row["over_library"] = ms / row["library_ms"]
    return row


def profile_f32(shapes=F32_SHAPES) -> dict:
    """Kernel-only ms a call of each f32 shape (split pass, attention
    kernel) and SDPA's kernels, from one ``torch.profiler`` session: per
    shape ``PROFILED`` kernel calls, then one SDPA call. Raises unless the
    trace holds 2 * PROFILED of the port's kernel events a shape."""
    from vr_video_generator_tpu_torch.models.depth_anything_v2 import no_tf32
    from vr_video_generator_tpu_torch.utils.profiling import trace

    cases = []
    with no_tf32():
        for label, kernel, b, n, heads in shapes:
            args, fn, _, sdpa = attention_case(kernel, b, n, heads,
                                               dtype=torch.float32)
            fn(*args), sdpa()
            cases.append((label, fn, args, sdpa))
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp, "trace.json"):
                for _, fn, args, sdpa in cases:
                    for _ in range(PROFILED):
                        fn(*args)
                    sdpa()
            with open(os.path.join(tmp, "trace.json"), encoding="utf-8") as f:
                events = json.load(f)["traceEvents"]
    kernels = sorted((e["ts"], e["name"], e["dur"]) for e in events
                     if e.get("cat") == "kernel" and "dur" in e)
    # In launch order: a shape's kernel calls, then its SDPA call's kernels.
    groups = []
    for _, name, dur in kernels:
        mine = any(k in name for k in F32_KERNELS)
        if mine and (not groups or groups[-1]["library"]):
            groups.append({"ours": [], "library": []})
        if groups:
            groups[-1]["ours" if mine else "library"].append((name, dur))
    if len(groups) != len(cases) or any(
            len(g["ours"]) != 2 * PROFILED for g in groups):
        raise RuntimeError(
            f"the f32 attention profile holds "
            f"{[len(g['ours']) for g in groups]} of the port's kernel events "
            f"a shape, not {2 * PROFILED} in each of {len(cases)}: a profile "
            f"that lost device events")
    out = {}
    for (label, *_), g in zip(cases, groups):
        by = {k: [dur / 1e3 for name, dur in g["ours"] if k in name]
              for k in F32_KERNELS}
        out[label] = dict(
            **{f"{k}_ms": sum(t) / len(t) for k, t in by.items()},
            kernel_only_ms=sum(sum(t) for t in by.values()) / PROFILED,
            library_kernels=sorted({name for name, _ in g["library"]}),
            library_kernel_ms=sum(dur for _, dur in g["library"]) / 1e3)
    return out


def sass_counts(kernels=("attention_kernel", "attention_f32_kernel",
                         "split_kv_kernel")) -> dict:
    """wgmma (HGMMA, and HGMMA_TF32: those with TF32 operands) and TMA
    instructions of each kernel of the built library whose name holds one
    of ``kernels`` (cuobjdump -sass)."""
    from vr_video_generator_tpu_torch.kernels.build import build, find_nvcc

    cuobjdump = str(find_nvcc()).replace("nvcc", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(build())],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if any(k in name for k in kernels):
            counts[name] = {op: len(re.findall(rf"\b{op}\b", chunk))
                            for op in ("HGMMA", "HMMA", "UTMALDG", "UTMASTG",
                                       "SYNCS", "MUFU.EX2", "FFMA")}
            counts[name]["HGMMA_TF32"] = len(
                re.findall(r"\bHGMMA\.\S*TF32", chunk))
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sass", action="store_true",
                    help="count wgmma/TMA instructions in the built kernels")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_bench: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    out = dict(card=card)
    if opts.sass:
        out["sass"] = sass_counts()
        print(f"sass: {json.dumps(out['sass'])}", flush=True)
    rows = []
    # The process's first profile (fault 5): before any other.
    out["f32_profile"] = profile_f32()
    print(f"f32 profile: {json.dumps(out['f32_profile'])}", flush=True)
    torch.cuda.empty_cache()
    for shape in SHAPES:
        rows.append(measure(*shape))
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    for shape in F32_SHAPES:
        rows.append(measure_f32(*shape))
        rows[-1].update(out["f32_profile"][shape[0]])
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    out["rows"] = rows
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
