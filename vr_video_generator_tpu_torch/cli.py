"""Command-line interface of the PyTorch port.

The same flags as vr_video_generator_tpu.cli: the 15 reference flags
(reference PredictAndGenerate.py:327-363) with their names and defaults,
unknown flags discarded via parse_known_args (:365), the same sign fixup of
the offsets (:387-393) and the same build knobs; plus ``--device`` (default
``cuda``). ``--mesh DxM`` runs the sharded runtime on D data slots of M
devices each (M splits the ViT's heads and MLP hidden); with
``--coordinator_address``, ``--num_processes`` and ``--process_id`` each
process runs its own slots of the global mesh (parallel/multihost.py).
``build_parser`` and ``parse_run_config`` are the port's own copy of the
JAX package's (the port imports nothing of it).

Usage:  python -m vr_video_generator_tpu_torch.cli --VideoDir in.mp4 \
            --OutputDir out.mkv [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from vr_video_generator_tpu_torch.utils.config import RunConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vr_video_generator_tpu_torch")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on: cuda or cpu; with --mesh, "
                        "cuda takes every card, and cpu or one card "
                        "(cuda:0) takes every slot and rank")
    # --- reference flags (names verbatim) ---
    p.add_argument("--DebugDir", type=str, default="./Debug/")
    p.add_argument("--SubClipDir", type=str, default="./Subclip/")
    p.add_argument("--VideoDir", type=str, default="./Videos/Input/input.mp4")
    p.add_argument("--OutputDir", type=str, default="output.mkv")
    p.add_argument("--encoder", type=str, default="vits")
    p.add_argument("--encoder_path", type=str,
                   default="./checkpoints/depth_anything_v2_vits.pth")
    p.add_argument("--offset_fg", type=float, default=0.025)
    p.add_argument("--offset_bg", type=float, default=-0.01)
    p.add_argument("--offset_step_size", type=int, default=1)
    p.add_argument("--Num_Workers", type=int, default=4)
    p.add_argument("--num_gpu", type=int, default=1)
    p.add_argument("--Num_GPU_Workers", type=int, default=1)
    p.add_argument("--Max_Frame_Count", type=int, default=15)
    p.add_argument("--start_frame", type=int, default=0)
    p.add_argument("--end_frame", type=int, default=99999999999999)
    p.add_argument("--repair_mode", type=int, default=0)
    # --- build flags (the JAX package's; the same names and defaults) ---
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--input_size", type=int, default=518)
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="depth-net compute dtype; on the card float32 runs "
                        "the f32 kernels (every plan of vits, vitb, vitl and "
                        "vitg); a custom head whose DPT tail has no f32 "
                        "kernel (32 features) raises NotImplementedError "
                        "before any weight is built")
    p.add_argument("--warp_impl", type=str, default="auto",
                   choices=["auto", "xla", "pallas"])
    p.add_argument("--encoder_device", type=str, default="cpu",
                   choices=["cpu", "nvidia"])
    p.add_argument("--allow_random_weights", action="store_true",
                   help="run with seeded random model weights when no "
                        "checkpoint is available (smoke tests/benchmarks)")
    p.add_argument("--gelu", type=str, default="exact",
                   choices=["exact", "tanh"],
                   help="tanh-approx GELU is ~0.2 ms/frame faster at "
                        "1080p/vits; exact matches the reference")
    p.add_argument("--sbs_output", type=str, default="auto",
                   choices=["auto", "u8", "packed"],
                   help="device SBS emit: u8 HWC frames or packed uint32 "
                        "words unpacked host-side (pallas warp only)")
    p.add_argument("--mlp_fused", type=str, default="auto",
                   choices=["auto", "fused", "xla"],
                   help="ViT half-block kernel fusion policy")
    p.add_argument("--tail", type=str, default="auto",
                   choices=["auto", "fused", "xla"],
                   help="DPT head tail implementation")
    p.add_argument("--reader_backend", type=str, default="auto",
                   choices=["auto", "cv2", "ffmpeg"])
    p.add_argument("--writer_backend", type=str, default="auto",
                   choices=["auto", "cv2", "ffmpeg"])
    p.add_argument("--preprocess", type=str, default="auto",
                   choices=["auto", "exact", "folded"],
                   help="depth-net input preprocessing: exact f32 INTER_AREA "
                        "or the folded bf16 fast path (auto: folded for a "
                        "bf16 model on the card, exact otherwise)")
    p.add_argument("--depth_stride", type=int, default=1,
                   help="run the depth net only on every s-th frame and "
                        "linearly interpolate raw depth in between (opt-in "
                        "speed/fidelity trade; 1 = reference parity; must "
                        "divide --batch_size)")
    p.add_argument("--stride_audit_every", type=int, default=0,
                   help="with --depth_stride > 1: every N-th full batch, "
                        "also run the depth net on all frames and log the "
                        "lerp-vs-true raw-depth rms/max to the worker log "
                        "(sampled fidelity evidence; 0 = off)")
    p.add_argument("--stride_max_rms", type=float, default=0.0,
                   help="with --depth_stride > 1: make the stride self-"
                        "protecting — drop to full per-frame depth whenever "
                        "the sampled lerp-vs-true rms (scaled units) exceeds "
                        "this, re-raise when it subsides; probes every "
                        "--stride_audit_every batches (default 8 when this "
                        "is set). 0 = fixed stride (audit only observes)")
    p.add_argument("--stride_hold", type=int, default=4,
                   help="minimum consecutive full-depth batches after an "
                        "adaptive-stride trigger before re-raising")
    p.add_argument("--depth_scaler", type=float, default=0.0,
                   help="override the encoder's depth rescale constant "
                        "(reference PredictAndGenerate.py:27-34). 0 = the "
                        "shipped per-encoder value; off-family checkpoints "
                        "(vitg, fine-tunes) should pass the value "
                        "scripts/real_weights_runbook.py calibrates")
    p.add_argument("--chunk_batches", type=int, default=1,
                   help="dispatch up to k consecutive full batches as one "
                        "superstep (on the card one CUDA graph replay; "
                        "bit-identical output; amortizes per-dispatch host "
                        "cost — see RunConfig). 1 = off")
    p.add_argument("--warmup_frames", type=int, default=32,
                   help="decode this many frames before each segment start "
                        "to prime the temporal smoothing state (0 = "
                        "reference-equal cold start)")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler Chrome trace of the "
                        "conversion here")
    p.add_argument("--mesh", type=str, default="",
                   help="(data,model) device-mesh shape, e.g. 4x1 or 2x2: "
                        "runs the sharded runtime, one contiguous segment "
                        "per data slot, each slot on a group of 'model' "
                        "devices that split the ViT's heads and MLP hidden "
                        "(--device cpu: that many CPU devices)")
    # multi-host bootstrap (torch.distributed, gloo); all three or none
    p.add_argument("--coordinator_address", type=str, default="",
                   help="host:port of process 0 for multi-host pod slices")
    p.add_argument("--num_processes", type=int, default=0)
    p.add_argument("--process_id", type=int, default=-1)
    return p


def parse_run_config(argv: Optional[List[str]] = None
                     ) -> tuple[RunConfig, argparse.Namespace]:
    args, unknown = build_parser().parse_known_args(argv)
    if unknown:
        print("Discarded arguments: ", unknown)

    offset_fg, offset_bg = args.offset_fg, args.offset_bg
    if offset_bg * offset_fg > 0:  # sign fixup (reference :387-393)
        if offset_bg >= 0:
            offset_bg = -offset_bg
        else:
            offset_fg = -offset_fg

    mesh_shape = None
    if args.mesh:
        parts = args.mesh.replace("x", ",").split(",")
        mesh_shape = tuple(int(v) for v in parts)

    cfg = RunConfig(
        debug_dir=args.DebugDir, subclip_dir=args.SubClipDir,
        video_dir=args.VideoDir, output_dir=args.OutputDir,
        encoder=args.encoder, encoder_path=args.encoder_path,
        offset_fg=offset_fg, offset_bg=offset_bg,
        offset_step_size=args.offset_step_size,
        num_workers=args.Num_Workers, num_gpu=args.num_gpu,
        num_gpu_workers=args.Num_GPU_Workers,
        max_frame_count=args.Max_Frame_Count,
        start_frame=args.start_frame, end_frame=args.end_frame,
        repair_mode=args.repair_mode, batch_size=args.batch_size,
        input_size=args.input_size, compute_dtype=args.compute_dtype,
        warp_impl=args.warp_impl, encoder_device=args.encoder_device,
        gelu=args.gelu, preprocess=args.preprocess,
        sbs_output=args.sbs_output, mlp_fused=args.mlp_fused,
        tail=args.tail, reader_backend=args.reader_backend,
        writer_backend=args.writer_backend, warmup_frames=args.warmup_frames,
        depth_stride=args.depth_stride,
        stride_audit_every=args.stride_audit_every,
        stride_max_rms=args.stride_max_rms, stride_hold=args.stride_hold,
        depth_scaler=args.depth_scaler, chunk_batches=args.chunk_batches,
        profile_dir=args.profile_dir, mesh_shape=mesh_shape,
    )
    return cfg, args


def main(argv: Optional[List[str]] = None) -> int:
    cfg, args = parse_run_config(argv)
    if cfg.mesh_shape is not None and len(cfg.mesh_shape) != 2:
        raise ValueError(f"--mesh takes DxM, got {args.mesh!r}")
    # The JAX CLI's condition: --process_id alone, or --num_processes 1
    # without a coordinator, runs single-host.
    from vr_video_generator_tpu_torch.parallel import multihost
    from vr_video_generator_tpu_torch.runtime.orchestrator import run

    if args.coordinator_address or args.num_processes > 1:
        multihost.initialize(args.coordinator_address or None,
                             args.num_processes or None,
                             args.process_id if args.process_id >= 0
                             else None)
    try:
        run(cfg, allow_random=args.allow_random_weights, device=args.device)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
