"""Configuration dataclasses — single source of truth for all knobs.

Mirrors the reference's argparse surface (reference PredictAndGenerate.py:327-363,
15 flags) plus the TPU-build's static compilation knobs. The reference's config
IS its command line (SURVEY.md §5); here the CLI (cli.py) parses into these
dataclasses so library users get a typed API while CLI users keep flag parity.

The port's own copy of vr_video_generator_tpu/utils/config.py, kept in step
with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# Per-encoder depth rescale constants; the reference applies these right after
# inference so every encoder lands on a ~[0, 14] depth range before the warp's
# /14 normalisation (reference PredictAndGenerate.py:27-34).
DEPTH_SCALERS = {
    "vits": 1.618,
    "vitb": 0.8,
    "vitl": 0.0208,
    # UNVALIDATED: the reference defines no vitg scaler (no official DA-V2
    # vitg checkpoint exists); 1.0 is a placeholder. When a checkpoint lands,
    # scripts/real_weights_runbook.py auto-calibrates a scaler to the family's
    # ~[0,14] scaled range — pass it via --depth_scaler / RunConfig.depth_scaler.
    "vitg": 1.0,
}


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    """Knobs of the stereo synthesis core (reference PredictAndGenerate.py:63-198)."""

    # Max foreground (pop-out) disparity as a fraction of frame height
    # (reference flag --offset_fg, default 0.025).
    offset_fg: float = 0.025
    # Max background (push-in) disparity, opposite sign (--offset_bg, -0.01).
    offset_bg: float = -0.01
    # Pixel-shift difference between adjacent depth planes (--offset_step_size).
    offset_step_size: int = 1
    # Number of previous raw depth maps blended into the current frame
    # (reference SbsProcessor.depth_dampening_count, :72).
    depth_dampening_count: int = 2
    # Geometric decay of the dampening weights (:73-80): weights are
    # 0.3, 0.3*0.4, ... over past frames; current frame takes the residual.
    depth_dampening_ratio: float = 0.4
    depth_dampening_initial_value: float = 0.3
    # Gaussian hole-fill sigma (reference SbsProcessor.sigmaboi, :84).
    sigma: float = 3.0
    # Static upper bound on ceil(depth.max()) used to size the padded plane
    # table. Encoders are rescaled to a ~[0,14] range (DEPTH_SCALERS), so 24
    # is generous; raising it only costs a larger (masked) plane axis.
    limit_step_cap: int = 24

    def normalized(self) -> "StereoConfig":
        """Force offset_fg/offset_bg to opposite signs like the reference's
        sign-sanity fixup (reference PredictAndGenerate.py:387-393), and
        reject SWAPPED signs outright: the reference's fixup only handles
        the same-sign case, so fg<0/bg>0 would flow through to a negative
        max_planes and crash deep in table construction with an obscure
        shape error."""
        fg, bg = self.offset_fg, self.offset_bg
        if bg * fg > 0:
            if bg >= 0:
                bg = -bg
            else:
                fg = -fg
        if fg < 0 or bg > 0:
            raise ValueError(
                f"offset_fg must be >= 0 (pop-out) and offset_bg <= 0 "
                f"(push-in); got offset_fg={fg}, offset_bg={bg} — the two "
                "values appear swapped")
        return dataclasses.replace(self, offset_fg=fg, offset_bg=bg)

    def max_planes(self, height: int) -> int:
        """Static bound on the per-frame cutoff-plane count.

        The reference builds a variable-length ``cutoff_list`` per frame from
        ``offset_range = [bg, fg] * H * ceil(depth.max())/14``
        (PredictAndGenerate.py:101-118); we pad to this bound so jit compiles
        one program per video resolution.
        """
        cfg = self.normalized()
        r1 = cfg.offset_fg * height * self.limit_step_cap / 14.0
        r0 = cfg.offset_bg * height * self.limit_step_cap / 14.0
        n_neg = int(math.ceil(-r0 / max(cfg.offset_step_size, 1))) + 1
        n_pos = int(math.ceil(r1 / max(cfg.offset_step_size, 1))) + 1
        return n_neg + n_pos + 2

    @property
    def dampening_weights(self) -> Tuple[float, ...]:
        """(w_current, w_t-1, w_t-2, ...) exactly as the reference derives them
        (PredictAndGenerate.py:74-80,137-142)."""
        t = self.depth_dampening_initial_value
        past = []
        for _ in range(self.depth_dampening_count):
            past.append(t)
            t *= self.depth_dampening_ratio
        current = 1.0 - sum(past)
        return (current, *past)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Depth-Anything-V2 model family configuration.

    Per-size values from the reference model factory
    (reference SupportFunction.py:158-168) and DINOv2 constructors
    (reference depth_anything_v2/dinov2.py:339-415, dpt.py:166-171).
    """

    encoder: str = "vits"
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    features: int = 64
    out_channels: Tuple[int, int, int, int] = (48, 96, 192, 384)
    intermediate_layers: Tuple[int, int, int, int] = (2, 5, 8, 11)
    patch_size: int = 14
    pretrain_img_size: int = 518  # pos-embed grid = 37x37 (+1 cls)
    layerscale_init: float = 1.0
    interpolate_offset: float = 0.1  # DINOv2 pos-embed interpolation quirk
    ffn_layer: str = "mlp"  # "swiglufused" for vitg
    # tanh-approx GELU saves ~0.8 ms/frame at 1080p/vits; deviation is the
    # same order as the bf16 noise floor but off by default for strict
    # parity with the reference's exact erf GELU (dinov2_layers/mlp.py:37)
    gelu_approx: bool = False
    # Half-block fusion policy for the ViT ('auto'|'fused'|'xla') —
    # models/dinov2.resolve_block_fusion; 'auto' fuses on the card (bf16).
    mlp_fused: str = "auto"
    depth_scaler: float = 1.618

    @staticmethod
    def for_encoder(encoder: str) -> "ModelConfig":
        common = dict(patch_size=14, pretrain_img_size=518, layerscale_init=1.0,
                      interpolate_offset=0.1)
        table = {
            "vits": dict(embed_dim=384, depth=12, num_heads=6, features=64,
                         out_channels=(48, 96, 192, 384),
                         intermediate_layers=(2, 5, 8, 11), ffn_layer="mlp"),
            "vitb": dict(embed_dim=768, depth=12, num_heads=12, features=128,
                         out_channels=(96, 192, 384, 768),
                         intermediate_layers=(2, 5, 8, 11), ffn_layer="mlp"),
            "vitl": dict(embed_dim=1024, depth=24, num_heads=16, features=256,
                         out_channels=(256, 512, 1024, 1024),
                         intermediate_layers=(4, 11, 17, 23), ffn_layer="mlp"),
            "vitg": dict(embed_dim=1536, depth=40, num_heads=24, features=384,
                         out_channels=(1536, 1536, 1536, 1536),
                         intermediate_layers=(9, 19, 29, 39),
                         ffn_layer="swiglufused"),
        }
        if encoder not in table:
            raise ValueError(f"unknown encoder {encoder!r}; expected one of {sorted(table)}")
        return ModelConfig(encoder=encoder, depth_scaler=DEPTH_SCALERS[encoder],
                           **common, **table[encoder])


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Full pipeline run configuration — superset of the reference's 15 CLI
    flags (reference PredictAndGenerate.py:327-363) plus TPU-build knobs."""

    # --- reference flag parity ---
    debug_dir: str = "./Debug/"
    subclip_dir: str = "./Subclip/"
    video_dir: str = "./Videos/Input/input.mp4"
    output_dir: str = "output.mkv"
    encoder: str = "vits"
    encoder_path: str = "./checkpoints/depth_anything_v2_vits.pth"
    offset_fg: float = 0.025
    offset_bg: float = -0.01
    offset_step_size: int = 1
    num_workers: int = 4          # host-side encode worker processes
    num_gpu: int = 1              # retained for flag parity; TPU chips come from the mesh
    num_gpu_workers: int = 1      # retained for flag parity (no server processes on TPU)
    max_frame_count: int = 15     # frames per subclip (checkpoint granularity)
    start_frame: int = 0
    end_frame: int = 99999999999999
    repair_mode: int = 0

    # --- TPU-build knobs ---
    batch_size: int = 8           # frames per device step
    input_size: int = 518         # depth-net target short side (multiple of 14)
    compute_dtype: str = "bfloat16"
    mesh_shape: Optional[Tuple[int, ...]] = None  # None -> all devices on 'data'
    encoder_device: str = "cpu"   # ffmpeg video-encoder selection ('cpu'|'nvidia')
    warp_impl: str = "auto"       # 'auto' | 'xla' | 'pallas' | 'scan'
    # SBS output encoding: 'u8' = (B, H, 2W, 3) uint8; 'packed' = (B, H, 2W)
    # uint32 r|g<<8|b<<16 (pallas warp only — edge/concat fused into the blur
    # kernel, host unpacks to rgb24 via the native tier). 'auto' = u8:
    # measured on device the fusion saves only ~0.02 ms/frame (XLA already
    # fuses the unpack/where/concat epilogue into one pass) while packed
    # readback costs +33% D2H (4 vs 3 bytes/pixel) — see docs/BENCHLOG.md.
    sbs_output: str = "auto"
    gelu: str = "exact"           # 'exact' (reference parity) | 'tanh' (fast)
    # Depth-net input preprocessing: 'exact' (f32 INTER_AREA + normalize,
    # reference-equal), 'folded' (bf16 GEMMs, /255+normalize folded — the
    # fast path), 'auto' = folded for a bf16 model on the card, else exact.
    preprocess: str = "auto"
    mlp_fused: str = "auto"       # ViT half-block fusion: 'auto'|'fused'|'xla'
    tail: str = "auto"            # DPT head tail impl: 'auto'|'fused'|'xla'
    reader_backend: str = "auto"  # video decode: 'auto'|'cv2'|'ffmpeg'
    writer_backend: str = "auto"  # subclip encode: 'auto'|'cv2'|'ffmpeg'
    # Depth-stride production mode: run the depth net only on every s-th
    # frame (the last of each s-frame group) and linearly interpolate the
    # raw depth in between (ops/temporal.stride_interpolate). 1 = reference
    # parity (every frame, default). Requires batch_size % depth_stride == 0.
    # Opt-in speed/fidelity trade the reference cannot express — its
    # architecture recomputes depth per frame; depth is temporally smooth
    # (the reference itself blends 3 consecutive raw maps), so stride 2 cuts
    # the dominant depth-net cost ~2x at a bounded depth lag.
    depth_stride: int = 1
    # Depth-stride fidelity audit: every N-th full batch, additionally run
    # the depth net on ALL frames and log the lerp-vs-true raw-depth error
    # (rms/max over the batch's non-anchor frames, scaled units) to the
    # worker log — sampled production evidence for the stride trade at
    # ~1/N of the cost stride saves. 0 = off; only meaningful with
    # depth_stride > 1. Single-chip and sharded runtimes (per-slot lines).
    stride_audit_every: int = 0
    # Adaptive depth-stride (self-protecting production mode): with
    # depth_stride > 1 and stride_max_rms > 0, the segment runtime probes
    # the lerp-vs-true depth error every stride_audit_every batches (the
    # existing sampled audit) and DROPS to full per-frame depth whenever the
    # probed rms exceeds this threshold (scaled raw-depth units), re-raising
    # the stride once the error subsides for stride_hold consecutive
    # batches. The full-depth fallback batches keep the absolute anchor
    # grid (batch % stride == 0), so returning to stride mode is seamless.
    # 0 = off (fixed stride; audit logs but never acts — round-3 behavior).
    stride_max_rms: float = 0.0
    # Minimum consecutive full-depth batches after a trigger before the
    # stride may re-raise (anti-thrash hold).
    stride_hold: int = 4
    # Depth-scaler override: 0.0 = the encoder's shipped DEPTH_SCALERS value.
    # Off-family checkpoints (vitg has no official DA-V2 release; fine-tunes
    # can land on arbitrary raw-depth ranges) should pass the value that
    # scripts/real_weights_runbook.py calibrates for them (it solves
    # scaler = target/raw_max against the reference family's ~[0,14] scaled
    # range, reference PredictAndGenerate.py:27-34).
    depth_scaler: float = 0.0
    # Chunked dispatch: the segment runtime groups up to this many
    # consecutive full batches into ONE superstep (SbsPipeline.step_many:
    # on the card one CUDA graph of the k steps, state carried inside it —
    # bit-identical to per-batch dispatch). Amortizes per-dispatch host
    # cost: an eager step makes hundreds of kernel launches from Python, a
    # replay one host call. The short last batch stays per-batch. 1 = off.
    chunk_batches: int = 1
    # Halo warm-up: decode this many frames before each segment start to
    # prime the temporal state (the reference resets per segment — a known
    # smoothing discontinuity). The 2-tap depth history is exact after 2
    # frames; the 50/50 offset-range EWMA converges to bit-equality with the
    # full sequential run within ~30 frames of f32 halving. 0 = cold start.
    warmup_frames: int = 32
    profile_dir: str = ""         # torch.profiler trace output dir ("" = off)

    def stereo(self) -> StereoConfig:
        return StereoConfig(offset_fg=self.offset_fg, offset_bg=self.offset_bg,
                            offset_step_size=self.offset_step_size).normalized()

    def model(self) -> ModelConfig:
        cfg = ModelConfig.for_encoder(self.encoder)
        if self.gelu == "tanh":
            cfg = dataclasses.replace(cfg, gelu_approx=True)
        if self.mlp_fused != "auto":
            cfg = dataclasses.replace(cfg, mlp_fused=self.mlp_fused)
        if self.depth_scaler:
            cfg = dataclasses.replace(cfg, depth_scaler=self.depth_scaler)
        return cfg
