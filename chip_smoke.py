#!/usr/bin/env python3
"""Smoke test of the PyTorch port (vr_video_generator_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py [--verbose-build]

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ with nvcc and compile the Triton
     LayerNorm;
  3. each kernel against its plain PyTorch version on the card at the main
     path's shapes (1080p, vits, batch 8), with CUDA-event timings of both;
  4. the main path: 3 batches of 8 random 1080x1920 frames through
     ``runtime.segment.process_segment`` with vits, bf16 and seeded random
     weights, with the kernels' launch counts, the frame rate, and checks of
     the output against the input and against the plain versions.

It prints the per-kernel JSON line before the last line, and as the last
line ``{"ok": true, "device": {...}}``. Without a CUDA device, or without
the package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

H, W, B, N_BATCHES = 1080, 1920, 8, 3
SEED = 0
# bf16 LayerNorm bound of the JAX package's tests (tests/test_layernorm.py).
LN_ATOL, LN_RTOL = 2e-2, 1e-2
# Online rescaling and the bf16 probabilities reorder the rounding. The
# absolute bounds are those of the port's design; the relative ones hold the
# error to a small share of the output's own size (max against max |o|,
# mean against mean |o|).
ATTN_MAX_ABS, ATTN_MEAN_ABS = 2e-2, 1e-3
ATTN_MAX_REL, ATTN_MEAN_REL = 2e-2, 5e-3
# Depth through the kernels against the plain versions. A random-weight
# 12-block ViT amplifies any one-ulp bf16 difference: on the H100 the plain
# bf16 path itself is up to ~3.8% of the depth range off the same weights in
# f32 at single pixels, while its mean error is ~0.4%. So the 2% bound holds
# the mean error, and the kernel path's error against f32 may be at most
# DEPTH_FLOOR times the plain bf16 path's, in max and in mean.
DEPTH_REL = 0.02
DEPTH_FLOOR = 1.25
KERNELS = {
    "layernorm": ("triton", "vr_video_generator_tpu_torch/ops/layernorm.py",
                  "vr_video_generator_tpu/ops/layernorm.py:33"),
    "attention": ("cuda", "vr_video_generator_tpu_torch/csrc/attention.cu",
                  "vr_video_generator_tpu/ops/attention_pallas.py:43"),
    "warp_composite": ("cuda", "vr_video_generator_tpu_torch/csrc/warp.cu",
                       "vr_video_generator_tpu/ops/warp_pallas.py:45"),
    "blur_select_sbs": ("cuda",
                        "vr_video_generator_tpu_torch/csrc/blur_select.cu",
                        "vr_video_generator_tpu/ops/warp_pallas.py:301"),
}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def synthetic_depth(rng, device):
    """(B, H, W) depth: a left-to-right ramp over [0, 14] plus noise, so
    many shifts are live and the warp leaves holes."""
    import torch

    ramp = np.linspace(0.0, 14.0, W, dtype=np.float32)[None, None, :]
    noise = rng.normal(0.0, 0.4, (B, H, W)).astype(np.float32)
    return torch.from_numpy(np.clip(ramp + noise, 0.0, None)).to(device)


def kernel_parity(device, rng, results):
    """Phase 3: each kernel against its plain version at main-path shapes."""
    import torch

    from vr_video_generator_tpu_torch import StereoConfig
    from vr_video_generator_tpu_torch.ops.attention import (attention,
                                                             attention_plain)
    from vr_video_generator_tpu_torch.ops.layernorm import (layernorm,
                                                             layernorm_plain)
    from vr_video_generator_tpu_torch.ops.temporal import (TemporalState,
                                                            temporal_scan)
    from vr_video_generator_tpu_torch.ops.warp import (
        WarpSpec, blur_select_sbs, blur_select_sbs_plain, warp_composite,
        warp_composite_plain)
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    n_tok, dim, heads = 2443, 384, 6  # 37 x 66 patches + cls at 1080p
    gen = torch.Generator(device=device).manual_seed(SEED)

    x = torch.randn(B * n_tok, dim, generator=gen, device=device).to(torch.bfloat16)
    w = torch.randn(dim, generator=gen, device=device)
    b = torch.randn(dim, generator=gen, device=device)
    got, want = layernorm(x, w, b), layernorm_plain(x, w, b)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    require(bool((err <= LN_ATOL + LN_RTOL * want.float().abs()).all()),
            f"layernorm: max abs err {err.max().item()} over "
            f"atol {LN_ATOL} + rtol {LN_RTOL}")
    results["layernorm"] = dict(
        max_abs_err=err.max().item(),
        ms=event_ms(lambda: layernorm(x, w, b)),
        plain_ms=event_ms(lambda: layernorm_plain(x, w, b)))

    # q pre-scaled as mha does; k and v strided views into a fused qkv.
    # The other logits have std ~1.5 (a peaked softmax), and head dim 0 adds
    # the same -4 to every logit: the softmax over the real keys is
    # unchanged, but a key at or past N that the kernel failed to mask
    # (logit 0) would weigh as much as e^4 real keys.
    qkv = torch.randn(B, n_tok, 3, heads, 64, generator=gen, device=device)
    qkv[:, :, 1] *= 1.5
    qkv[:, :, 0, :, 0] = 4.0
    qkv[:, :, 1, :, 0] = -8.0
    qkv = qkv.to(torch.bfloat16)
    q = (qkv[:, :, 0].float() * 64 ** -0.5).to(torch.bfloat16)
    k, v = qkv[:, :, 1], qkv[:, :, 2]
    got, want = attention(q, k, v), attention_plain(q, k, v)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    size = want.float().abs()
    stats = dict(max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
                 max_rel_err=(err.max() / size.max()).item(),
                 mean_rel_err=(err.mean() / size.mean()).item())
    require(stats["max_abs_err"] <= ATTN_MAX_ABS
            and stats["mean_abs_err"] <= ATTN_MEAN_ABS
            and stats["max_rel_err"] <= ATTN_MAX_REL
            and stats["mean_rel_err"] <= ATTN_MEAN_REL,
            f"attention: {json.dumps(stats)} over bounds max abs "
            f"{ATTN_MAX_ABS}, mean abs {ATTN_MEAN_ABS}, max rel "
            f"{ATTN_MAX_REL}, mean rel {ATTN_MEAN_REL}")
    results["attention"] = dict(
        **stats,
        ms=event_ms(lambda: attention(q, k, v)),
        plain_ms=event_ms(lambda: attention_plain(q, k, v)))
    del qkv, q, k, v, got, want

    spec = WarpSpec.create(H, W, StereoConfig())
    imgs = torch.from_numpy(
        rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)).to(device)
    depth = synthetic_depth(rng, device)
    blended, ranges, _ = temporal_scan(depth, TemporalState.initial(H, W, device),
                                       spec)
    _, st = spec.tables(blended, ranges)
    comp, cov = warp_composite(imgs, blended, st, spec.s_neg, spec.s_pos)
    comp_p, cov_p = warp_composite_plain(imgs, blended, st, spec.s_neg,
                                         spec.s_pos)
    torch.cuda.synchronize()
    warp_err = max(float((comp.int() - comp_p.int()).abs().max()),
                   float((cov.int() - cov_p.int()).abs().max()))
    require(warp_err == 0, f"warp_composite differs from plain by {warp_err}")
    log(f"warp check input: live shifts per frame "
        f"{st.valid.sum(dim=1).tolist()} of {spec.s_neg + spec.s_pos + 1}, "
        f"hole fraction {1.0 - cov.float().mean().item():.4f}")
    results["warp_composite"] = dict(
        max_abs_err=warp_err,
        ms=event_ms(lambda: warp_composite(imgs, blended, st, spec.s_neg,
                                          spec.s_pos)),
        plain_ms=event_ms(lambda: warp_composite_plain(imgs, blended, st,
                                                      spec.s_neg, spec.s_pos)))

    args = (comp_p, cov_p, imgs, st.edge_width, spec.kernel_size,
            spec.cfg.sigma)
    sbs, sbs_p = blur_select_sbs(*args), blur_select_sbs_plain(*args)
    torch.cuda.synchronize()
    sbs_err = float((sbs.int() - sbs_p.int()).abs().max())
    require(sbs_err == 0, f"blur_select_sbs differs from plain by {sbs_err}")
    results["blur_select_sbs"] = dict(
        max_abs_err=sbs_err, ms=event_ms(lambda: blur_select_sbs(*args)),
        plain_ms=event_ms(lambda: blur_select_sbs_plain(*args)))
    for name, r in results.items():
        log(f"kernel {name}: {json.dumps(r)}")


class PlainKernels:
    """Swap the model's kernel wrappers for their plain versions (to hold
    the kernel path against the plain path on the same card)."""

    def __enter__(self):
        from vr_video_generator_tpu_torch.models import dinov2
        from vr_video_generator_tpu_torch.ops import attention, layernorm

        self._saved = (dinov2.layernorm, attention.attention)
        dinov2.layernorm = layernorm.layernorm_plain
        attention.attention = attention.attention_plain
        return self

    def __exit__(self, *exc):
        from vr_video_generator_tpu_torch.models import dinov2
        from vr_video_generator_tpu_torch.ops import attention

        dinov2.layernorm, attention.attention = self._saved
        return False


def main_path(device, rng, card):
    """Phase 4: the port's main path through process_segment."""
    import torch

    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.kernels import (launch_counts,
                                                       reset_launch_counts)
    from vr_video_generator_tpu_torch.ops.temporal import temporal_scan
    from vr_video_generator_tpu_torch.ops.warp import warp_composite_plain
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline
    from vr_video_generator_tpu_torch.runtime.segment import process_segment
    from vr_video_generator_tpu_torch.stage_bench import (
        CollectingWriter, MemoryReader, calibrate_random_scaler)

    cfg = RunConfig(encoder="vits", batch_size=B, compute_dtype="bfloat16",
                    mlp_fused="xla", tail="xla", max_frame_count=15)
    t0 = time.perf_counter()
    pipe = SbsPipeline.create(cfg, H, W, allow_random=True, device=device,
                              seed=SEED)
    log(f"model: vits, bf16, random weights (numpy seed {SEED}), "
        f"{time.perf_counter() - t0:.2f} s to build")
    frames = rng.integers(0, 256, (N_BATCHES * B, H, W, 3), dtype=np.uint8)

    scaler = calibrate_random_scaler(pipe, frames[:B])
    log(f"depth scaler calibrated to {scaler:.6g} on the first batch")
    _, state = pipe.step(frames[:B], pipe.initial_state())  # warm-up
    # A step must only enqueue work: a host sync inside it would serialise
    # the segment loop's upload, compute and readback.
    on_device = pipe.frames_to_device(frames[B:2 * B])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe.step(on_device, state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("main path step: no host sync (torch.cuda sync debug mode 'error')")

    writer = CollectingWriter()
    reset_launch_counts()
    t0 = time.perf_counter()
    n = process_segment(pipe, MemoryReader(frames), writer, 0, len(frames),
                        max_frame_count=cfg.max_frame_count, batch_size=B)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = launch_counts()
    fps = len(frames) / elapsed
    log(f"main path: {n} frames in {elapsed:.4f} s = {fps:.3f} frames/s "
        f"on {card}")
    log(f"launch counts: {json.dumps(counts)}")
    for name in KERNELS:
        require(counts.get(name, 0) > 0,
                f"kernel {name} was not launched on the main path")

    out = np.stack(writer.frames)
    require(n == len(frames) and out.shape == (len(frames), H, 2 * W, 3)
            and out.dtype == np.uint8,
            f"output {out.shape} {out.dtype}, {n} frames written")
    require(np.array_equal(out[:, :, W:], frames),
            "right half of the SBS differs from the input")
    require(bool(np.isfinite(out).all()), "non-finite output")

    # The step's SBS against the plain warp of its own blended depth.
    batch = pipe.frames_to_device(frames[:B])
    state0 = pipe.initial_state()
    sbs, _ = pipe.step(batch, state0)
    with torch.inference_mode():
        depth = pipe.depth_only(batch)
        blended, ranges, _ = temporal_scan(depth, state0, pipe.spec)
        plain_sbs = pipe.spec.warp_batch_plain(batch, blended, ranges)
        _, st = pipe.spec.tables(blended, ranges)
        _, cov = warp_composite_plain(batch, blended, st, pipe.spec.s_neg,
                                      pipe.spec.s_pos)
    n_bad = int((sbs != plain_sbs).sum())
    require(n_bad == 0, f"step SBS differs from the plain warp in {n_bad} values")
    live = st.valid.sum(dim=1).tolist()
    holes = 1.0 - cov.float().mean().item()
    log(f"main path warp: live shifts per frame {live} of "
        f"{pipe.spec.s_neg + pipe.spec.s_pos + 1}, hole fraction {holes:.4f}, "
        f"depth range [{float(depth.min()):.4f}, {float(depth.max()):.4f}]")

    depth_stats = depth_agreement(pipe, cfg, batch, depth)
    return counts, dict(frames=n, seconds=elapsed, fps=fps,
                        live_shifts=live, hole_fraction=holes, **depth_stats)


def depth_agreement(pipe, cfg, batch, depth):
    """Depth through the kernels (bf16) against the plain versions in bf16
    and in f32, on the same weights and frames."""
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    with PlainKernels():
        plain = pipe.depth_only(batch)
        pipe32 = SbsPipeline.create(
            dataclasses.replace(cfg, compute_dtype="float32"), H, W,
            allow_random=True, device=batch.device, seed=SEED)
        pipe32.model.cfg = pipe.model.cfg  # the calibrated scaler
        ref32 = pipe32.depth_only(batch)
        del pipe32
    span = float(plain.max() - plain.min())
    d_kp = (depth - plain).abs()
    d_k32 = (depth - ref32).abs()
    d_p32 = (plain - ref32).abs()
    stats = dict(depth_range=span,
                 depth_kernel_vs_plain_max=float(d_kp.max()),
                 depth_kernel_vs_plain_mean=float(d_kp.mean()),
                 depth_kernel_vs_f32_max=float(d_k32.max()),
                 depth_kernel_vs_f32_mean=float(d_k32.mean()),
                 depth_plain_bf16_vs_f32_max=float(d_p32.max()),
                 depth_plain_bf16_vs_f32_mean=float(d_p32.mean()))
    log(f"depth agreement: {json.dumps(stats)}")
    require(stats["depth_kernel_vs_plain_mean"] <= DEPTH_REL * span,
            f"depth through the kernels is off the plain path by "
            f"{stats['depth_kernel_vs_plain_mean']} on average (limit "
            f"{DEPTH_REL} x range {span})")
    for kind in ("max", "mean"):
        require(stats[f"depth_kernel_vs_f32_{kind}"]
                <= DEPTH_FLOOR * stats[f"depth_plain_bf16_vs_f32_{kind}"],
                f"kernel depth error vs f32 ({kind}) exceeds {DEPTH_FLOOR} x "
                f"the plain bf16 path's: {json.dumps(stats)}")
    return stats


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc's -Xptxas -v report")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "vr_video_generator_tpu_torch")):
        print(f"chip_smoke: the package vr_video_generator_tpu_torch is not "
              f"beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    from vr_video_generator_tpu_torch.stage_bench import card_line

    card = card_line()
    log(card)  # nvidia-smi's own "name, power.limit" line
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    from vr_video_generator_tpu_torch.kernels import build
    from vr_video_generator_tpu_torch.ops.layernorm import layernorm

    t0 = time.perf_counter()
    if opts.verbose_build:
        build.build(verbose=True)
    build.library()
    t_nvcc = time.perf_counter() - t0
    x = torch.zeros(4, 384, dtype=torch.bfloat16, device=device)
    layernorm(x, torch.ones(384, device=device), torch.zeros(384, device=device))
    torch.cuda.synchronize()
    log(f"build: nvcc {t_nvcc:.2f} s, with the Triton LayerNorm "
        f"{time.perf_counter() - t0:.2f} s")

    results = {}
    kernel_parity(device, rng, results)
    counts, slice_stats = main_path(device, rng, card)
    log(f"slice: {json.dumps(dict(slice_stats, card=card))}")

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = results[name]
        kernels.append(dict(name=name, route=route, source=source,
                            replaces=replaces, launches=counts[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
