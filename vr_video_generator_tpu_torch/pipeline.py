"""The per-batch SBS pipeline on one device (PyTorch).

Mirrors vr_video_generator_tpu/pipeline.py:

    uint8 RGB frames (B, H, W, 3)
      -> preprocess (/255, INTER_AREA resize, ImageNet normalize: exact in
         f32, or folded into bf16 products; ``preprocess`` auto is folded
         for a bf16 model on the card)
      -> DINOv2 + DPT depth forward (compute dtype; LayerNorm, attention,
         fused half-block and DPT tail kernels as mlp_fused / tail pick)
      -> bicubic upsample to the source size x encoder scaler
      -> with ``depth_stride`` s > 1 the depth net runs on every s-th
         frame only and raw depth is lerped in between
         (``ops.temporal.stride_interpolate``)
      -> temporal EWMA (depth dampening + offset-range smoothing)
      -> plane/shift tables, forward-warp compositor kernel, hole-fill +
         SBS kernel (``warp_impl``: the kernels, or their plain versions)
      -> uint8 (B, H, 2W, 3), or with ``sbs_output="packed"`` uint32
         (B, H, 2W) words r | g<<8 | b<<16 that the writer unpacks

The temporal state crosses batch boundaries, so batching is invisible.
PyTorch runs eagerly: ``step`` enqueues the batch's work on the device's
current stream and returns without waiting for it. ``step_many`` runs k
whole batches; on the card it replays them as one CUDA graph
(:class:`StepGraph`), one host call where eager steps make hundreds of
launches each.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vr_video_generator_tpu_torch.utils.config import RunConfig
from vr_video_generator_tpu_torch import not_ported
from vr_video_generator_tpu_torch.models.depth_anything_v2 import (
    DepthAnythingV2, infer_depth)
from vr_video_generator_tpu_torch.models.dinov2 import resolve_block_fusion
from vr_video_generator_tpu_torch.models.dpt import TAILS, resolve_tail
from vr_video_generator_tpu_torch.models.factory import load_model
from vr_video_generator_tpu_torch.ops.head_tail import takes_f32
from vr_video_generator_tpu_torch.ops.preprocess import network_input_size
from vr_video_generator_tpu_torch.ops.temporal import (TemporalState,
                                                        stride_audit_stats,
                                                        stride_interpolate,
                                                        temporal_scan)
from vr_video_generator_tpu_torch.ops.warp import WarpSpec

SBS_OUTPUTS = ("auto", "u8", "packed")


def resolve_device(device: torch.device | str) -> torch.device:
    """The torch device to run on; a CUDA device without a usable GPU
    raises rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but no CUDA GPU "
                           "is available (torch.cuda.is_available() is "
                           "False); pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def check_supported(run_cfg: RunConfig) -> None:
    """Raise for invalid RunConfig options (the JAX package's
    ``_check_depth_stride``) and for those this package does not have yet."""
    s = run_cfg.depth_stride
    if s < 1:
        raise ValueError(f"depth_stride must be >= 1, got {s}")
    if run_cfg.chunk_batches < 1:
        raise ValueError(f"chunk_batches must be >= 1, "
                         f"got {run_cfg.chunk_batches}")
    if s > 1 and run_cfg.batch_size % s:
        raise ValueError(
            f"depth_stride={s} must divide batch_size={run_cfg.batch_size} "
            "(each device batch is split into whole anchor groups)")
    if run_cfg.sbs_output not in SBS_OUTPUTS:
        raise ValueError(f"sbs_output must be one of {SBS_OUTPUTS}, "
                         f"got {run_cfg.sbs_output!r}")
    # An unknown mlp_fused raises here, before any weight is built (every
    # width either half fuses at has its kernels). The tail's choice depends
    # on the geometry; the head resolves it.
    cfg = run_cfg.model()
    resolve_block_fusion(cfg.mlp_fused, cfg.embed_dim, cfg.num_heads, 1, "cpu",
                         torch.float32, cfg.ffn_layer)
    if run_cfg.tail not in TAILS:
        raise ValueError(f"tail must be one of {TAILS}, got {run_cfg.tail!r}")


def check_f32_plan(run_cfg: RunConfig, height: int, width: int) -> None:
    """``compute_dtype`` float32 on the card: raise ``not_ported`` where the
    plan the JAX package's planners make at f32 for this geometry needs a
    DPT tail at a width no f32 tail kernel takes (ops/head_tail.takes_f32:
    the ext tail C = 32 to 384, the big-C tail 64 to 384; a custom head of
    16 features has neither), naming the rows. Every depth-net kernel has an
    f32 variant, vitg's fused SwiGLU half (row 10) included, which covers
    every plan of vits, vitb, vitl and vitg and of a 32-feature head. The
    MLP half's fusion is resolved too, so a width its kernel does not take
    raises here. It reads only the config, so it runs before any weight is
    built."""
    cfg = run_cfg.model()
    p, d = cfg.patch_size, cfg.embed_dim
    hn, wn = network_input_size(height, width, target=run_cfg.input_size,
                                multiple_of=p)
    ph, pw = hn // p, wn // p
    f32 = torch.float32
    resolve_block_fusion(cfg.mlp_fused, d, cfg.num_heads, ph * pw + 1, "cuda",
                         f32, cfg.ffn_layer)
    batch = max(run_cfg.batch_size // run_cfg.depth_stride, 1)
    pre = (batch, 4 * ph, 4 * pw, cfg.features)
    choice = resolve_tail(run_cfg.tail, pre, f32, (hn, wn), "cuda")
    if choice and not takes_f32(cfg.features, choice):
        rows = "row 7" if choice == "ext" else "rows 11 and 12"
        not_ported(f"compute_dtype='float32' on the card: the {choice} DPT "
                   f"tail at C={cfg.features} (tail={run_cfg.tail!r}, "
                   f"refinenet1 grid {pre[1]}x{pre[2]}) needs {rows} at f32",
                   "DPT tail kernels at other widths")


class SbsPipeline:
    """Single-device pipeline for a fixed (height, width) video geometry."""

    def __init__(self, model: DepthAnythingV2, height: int, width: int,
                 run_cfg: Optional[RunConfig] = None):
        self.run_cfg = run_cfg or RunConfig(encoder=model.cfg.encoder)
        check_supported(self.run_cfg)
        self.model = model
        self.device = next(model.parameters()).device
        self.height, self.width = height, width
        self.spec = WarpSpec.create(height, width, self.run_cfg.stereo(),
                                    impl=self.run_cfg.warp_impl,
                                    device=self.device)
        self.sbs_emit = resolve_sbs_emit(self.run_cfg)
        self.preprocess_impl = resolve_preprocess(
            self.run_cfg.preprocess, self.device.type, model.dtype)
        self._graphs: Dict[Tuple[int, int], StepGraph] = {}

    @classmethod
    def create(cls, run_cfg: RunConfig, height: int, width: int,
               allow_random: bool = False, dtype: Optional[torch.dtype] = None,
               device: torch.device | str = "cuda",
               seed: int = 0) -> "SbsPipeline":
        check_supported(run_cfg)
        device = resolve_device(device)
        if dtype is None:
            dtype = (torch.bfloat16 if run_cfg.compute_dtype == "bfloat16"
                     else torch.float32)
        if device.type == "cuda" and dtype == torch.float32:
            # A plan that needs an f32 kernel not ported yet raises here,
            # before any weight is built.
            check_f32_plan(run_cfg, height, width)
        model = load_model(run_cfg.encoder, run_cfg.encoder_path, dtype=dtype,
                           device=device, allow_random=allow_random,
                           seed=seed, cfg=run_cfg.model(), tail=run_cfg.tail)
        return cls(model, height, width, run_cfg=run_cfg)

    def initial_state(self) -> TemporalState:
        return TemporalState.initial(self.height, self.width, self.device,
                                     depth_stride=self.run_cfg.depth_stride)

    def frames_to_device(self, frames_u8) -> torch.Tensor:
        """(B, H, W, 3) uint8 numpy array or tensor -> tensor on the device."""
        if isinstance(frames_u8, np.ndarray):
            frames_u8 = torch.from_numpy(np.ascontiguousarray(frames_u8))
        if frames_u8.dtype != torch.uint8 or frames_u8.ndim != 4 \
                or tuple(frames_u8.shape[1:]) != (self.height, self.width, 3):
            raise ValueError(f"expected uint8 (B, {self.height}, {self.width}, "
                             f"3) frames, got {frames_u8.dtype} "
                             f"{tuple(frames_u8.shape)}")
        return frames_u8.to(self.device, non_blocking=True)

    def _depth(self, frames: torch.Tensor) -> torch.Tensor:
        return infer_depth(self.model, frames,
                           input_size=self.run_cfg.input_size,
                           preprocess=self.preprocess_impl)

    @torch.inference_mode()
    def step(self, frames_u8, state: TemporalState,
             n_valid: Optional[int] = None
             ) -> Tuple[torch.Tensor, TemporalState]:
        """One batch -> (SBS on the device, state'): (B, H, 2W, 3) uint8, or
        with ``sbs_emit == "packed"`` (B, H, 2W) uint32 words for the
        host's rgb24 unpack (native.unpack_sbs). ``n_valid``: how many
        leading frames are real (the rest are padding copies); only those
        count toward the overflow tally. With ``depth_stride`` s > 1 the
        depth net runs on frames s-1, 2s-1, ... (the last of each group)
        and the state carries the last anchor."""
        frames = self.frames_to_device(frames_u8)
        s = self.run_cfg.depth_stride
        if s > 1:
            if frames.shape[0] % s:
                raise ValueError(f"batch {frames.shape[0]} not divisible by "
                                 f"depth_stride {s}")
            depth, anchor_last = stride_interpolate(
                self._depth(frames[s - 1::s]), state, s)
        else:
            depth = self._depth(frames)
        blended, ranges, state = temporal_scan(depth, state, self.spec,
                                               n_valid=n_valid)
        if s > 1:
            state = state._replace(anchor_prev=anchor_last)
        return self.spec.warp_batch(frames, blended, ranges,
                                    emit=self.sbs_emit), state

    def step_many(self, frames_u8, state: TemporalState
                  ) -> Tuple[Tuple[torch.Tensor, ...], TemporalState]:
        """k whole batches -> (k SBS tensors, state'), bit-identical to k
        ``step`` calls, state included. ``frames_u8``: (k, B, H, W, 3)
        uint8, numpy or tensor. It takes no ``n_valid``: every frame is
        real (a short batch goes to ``step``).

        On the CPU it is the loop of ``step``. On the card the k steps are
        one CUDA graph (:class:`StepGraph`), captured at the first call of
        each (k, B) and replayed after: the frames are copied into its
        static input, the caller's state into its static state, and the
        outputs are clones of its static outputs, so no result of one call
        aliases another's. A failed capture or replay raises."""
        frames = (torch.from_numpy(np.ascontiguousarray(frames_u8))
                  if isinstance(frames_u8, np.ndarray) else frames_u8)
        if frames.ndim != 5:
            raise ValueError(f"step_many expects (k, B, H, W, 3) uint8, got "
                             f"shape {tuple(frames.shape)}")
        if self.device.type != "cuda":
            outs = []
            for batch in frames:
                sbs, state = self.step(batch, state)
                outs.append(sbs)
            return tuple(outs), state
        key = tuple(frames.shape[:2])
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = StepGraph(self, frames, state)
        return graph.run(frames, state)

    def primed_state(self, warm_frames, batch_size: int,
                     min_batches: int = 0) -> TemporalState:
        """State after feeding the frames [begin-W, begin), so a segment
        start continues the full-video sequence instead of resetting.

        At depth_stride 1, front-padding the window to whole batches with
        copies of its first frame is exact: copies are a fixed point of the
        cold start. At depth_stride > 1 they are not (they prime the anchor
        carry), so the pad count is part of the warm-up's trajectory:
        ``min_batches`` pins the number of fed batches whatever the window's
        length, and the orchestrator passes ceil(warm-up / batch)."""
        state = self.initial_state()
        warm = np.asarray(warm_frames)
        n = warm.shape[0]
        if n == 0:
            return state
        k = max(-(-n // batch_size), min_batches)
        pad = k * batch_size - n
        if pad:
            warm = np.concatenate([np.repeat(warm[:1], pad, axis=0), warm])
        for i in range(k):
            _, state = self.step(warm[i * batch_size:(i + 1) * batch_size],
                                 state)
        # warm-up frames do not count toward the segment's overflow tally
        return state._replace(overflow=torch.zeros_like(state.overflow))

    def _require_stride(self, what: str) -> int:
        s = self.run_cfg.depth_stride
        if s < 2:
            raise ValueError(f"{what} requires depth_stride > 1")
        return s

    @torch.inference_mode()
    def step_audited(self, frames_u8, state: TemporalState,
                     n_valid: Optional[int] = None
                     ) -> Tuple[torch.Tensor, TemporalState, float, float]:
        """(sbs, state', stride_rms, stride_max): the adaptive stride's
        full-depth batch. Depth runs on every frame (the SBS is what the
        stride-1 step gives), the stats say what the stride path would
        have erred on this batch given the carried anchor (read back to the
        host, a sync), and ``anchor_prev`` becomes the batch's last frame's
        raw depth, unclamped, an anchor position of the absolute grid."""
        s = self._require_stride("step_audited")
        frames = self.frames_to_device(frames_u8)
        true = self._depth(frames)
        rms, mx = stride_audit_stats(true, state, s)
        blended, ranges, state = temporal_scan(true, state, self.spec,
                                               n_valid=n_valid)
        state = state._replace(anchor_prev=true[-1])
        sbs = self.spec.warp_batch(frames, blended, ranges, emit=self.sbs_emit)
        return sbs, state, float(rms), float(mx)

    @torch.inference_mode()
    def stride_audit(self, frames_u8, state: TemporalState
                     ) -> Tuple[float, float]:
        """The sampled stride audit, read-only: depth on EVERY frame of the
        batch against what the stride path would interpolate from its
        anchors and the carried ``anchor_prev``. Returns (rms, max) in
        scaled raw-depth units over the non-anchor frames (a host sync)."""
        s = self._require_stride("stride_audit")
        rms, mx = stride_audit_stats(
            self._depth(self.frames_to_device(frames_u8)), state, s)
        return float(rms), float(mx)

    @torch.inference_mode()
    def depth_only(self, frames_u8) -> torch.Tensor:
        """Depth maps at source resolution (scaled), (B, H, W) f32."""
        return self._depth(self.frames_to_device(frames_u8))


class StepGraph:
    """k steps of one pipeline captured as one CUDA graph.

    Capture needs every lazy set-up of a step done before it: the kernels'
    nvcc builds, cuBLAS's handle, the host tables each wrapper copies to
    the card at its first call (a copy from pageable host memory cannot be
    captured). So one eager step runs first, on the caller's first batch
    and a throwaway copy of the state. The capture then records the k
    steps on static buffers: the frames (k, B, H, W, 3), the state in, and
    the k SBS tensors and the state out, which live in the graph's private
    memory pool. At depth_stride 1 the state's ``anchor_prev`` is None and
    stays out of the copies; at s > 1 it is the sixth static tensor.

    The capture runs on a stream of the pipeline's device, so a pipeline
    on any card captures (the data axis has one a slot).

    Each wrapper's ``LaunchCounter`` counts in Python, so it counts at
    capture, when nothing runs. The counts a capture adds are taken back
    and kept as ``launches``, the kernel launches of one replay, and each
    replay adds them.
    """

    def __init__(self, pipe: SbsPipeline, frames: torch.Tensor,
                 state: TemporalState):
        from vr_video_generator_tpu_torch.kernels import COUNTERS

        k, b = frames.shape[:2]
        self.frames = torch.empty((k, b, pipe.height, pipe.width, 3),
                                  dtype=torch.uint8, device=pipe.device)
        self.state = state.map(torch.empty_like)
        with torch.inference_mode():
            self.frames.copy_(frames)
            pipe.step(self.frames[0], state.map(torch.clone))
        torch.cuda.synchronize(pipe.device)
        before = {name: c.count for name, c in COUNTERS.items()}
        self.graph = torch.cuda.CUDAGraph()
        # A capture stream on the pipeline's device: torch.cuda.graph's
        # default one is made once per process, on the device current then,
        # and a capture of another device's work on it fails.
        capture = torch.cuda.Stream(pipe.device)
        with torch.inference_mode(), torch.cuda.graph(self.graph,
                                                      stream=capture):
            st, outs = self.state, []
            for i in range(k):
                sbs, st = pipe.step(self.frames[i], st)
                outs.append(sbs)
        self.outs, self.out_state = tuple(outs), st
        self.launches: Dict[str, int] = {}
        for name, c in COUNTERS.items():
            n = c.count - before.get(name, 0)
            c.count -= n
            if n:
                self.launches[name] = n

    @torch.inference_mode()
    def run(self, frames: torch.Tensor, state: TemporalState
            ) -> Tuple[Tuple[torch.Tensor, ...], TemporalState]:
        from vr_video_generator_tpu_torch.kernels import counter

        self.frames.copy_(frames, non_blocking=True)
        for dst, src in zip(self.state, state):
            if dst is not None:
                dst.copy_(src)
        self.graph.replay()
        for name, n in self.launches.items():
            counter(name).count += n
        return (tuple(o.clone() for o in self.outs),
                self.out_state.map(torch.clone))


def resolve_preprocess(preprocess: str, device_type: str,
                       dtype: torch.dtype) -> str:
    """The preprocess path (the JAX package's pipeline
    `_resolve_preprocess`, with CUDA in the TPU's place): "auto" is
    "folded" for a bf16 model on the card, "exact" otherwise."""
    if preprocess == "auto":
        return ("folded" if device_type == "cuda" and dtype == torch.bfloat16
                else "exact")
    return preprocess


def resolve_sbs_emit(run_cfg: RunConfig) -> str:
    """The SBS emit (the JAX package's pipeline `_resolve_sbs_emit`): "auto"
    is "u8"; "packed" is opt-in and needs the pallas warp (WarpSpec raises
    otherwise, at the first step, as the JAX package's does)."""
    return "u8" if run_cfg.sbs_output == "auto" else run_cfg.sbs_output
