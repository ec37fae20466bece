"""Model factory: the port's checkpoint directories, official checkpoints or
seeded random weights (numpy)."""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from vr_video_generator_tpu_torch.utils.config import ModelConfig
from vr_video_generator_tpu_torch.models import checkpoint
from vr_video_generator_tpu_torch.models.depth_anything_v2 import (
    DepthAnythingV2, ModelGroup)
from vr_video_generator_tpu_torch.parallel.sharding import (check_model_axis,
                                                            shard_state_dict)

# Parameters that stay f32 whatever the compute dtype: LayerNorm affine
# (f32 statistics and affine, as in the JAX package) and the pos-embed
# (resampled in f32, then cast).
_F32_SUFFIXES = ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias",
                 "pretrained.norm.weight", "pretrained.norm.bias",
                 "pretrained.pos_embed")


def random_state_dict(cfg: ModelConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded random upstream state_dict, drawn with numpy: LeCun-normal
    weights (std 1/sqrt(fan_in)), zero biases, cls and mask tokens, unit
    LayerNorm scales and LayerScale gammas, N(0, 0.02) pos-embed, matching
    the JAX package's initialisers in distribution. The shapes come from a
    model on the meta device (no storage), and each tensor is drawn alone,
    so the host holds the f32 state_dict and one f64 draw (vitg: ~1.3 B
    parameters, ~5 GB)."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape)
                  for k, v in DepthAnythingV2(cfg).state_dict().items()}
    sd = {}
    for name, shape in shapes.items():
        if name.endswith("pos_embed"):
            arr = rng.normal(0.0, 0.02, shape)
        elif name.endswith(("cls_token", "mask_token", ".bias")):
            arr = np.zeros(shape)
        elif name.endswith(".gamma") or len(shape) == 1:
            arr = np.ones(shape)  # LayerScale gamma, LayerNorm weight
        else:
            if "resize_layers.0" in name or "resize_layers.1" in name:
                fan_in = shape[0] * shape[2] * shape[3]  # ConvTranspose (I, O, r, r)
            else:
                fan_in = int(np.prod(shape[1:]))
            arr = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        sd[name] = arr.astype(np.float32)
    return sd


def build_model(cfg: ModelConfig, state_dict: Mapping, dtype: torch.dtype,
                device: torch.device | str, tail: str = "auto"
                ) -> DepthAnythingV2:
    """DepthAnythingV2 with ``state_dict`` loaded strictly, moved to
    ``device`` and cast to the compute dtype (f32 kept where noted). The
    model is built on the meta device and takes copies of the state_dict's
    tensors as its parameters, so no initial weights are drawn."""
    with torch.device("meta"):
        model = DepthAnythingV2(cfg, dtype=dtype, tail=tail)
    model.load_state_dict(
        {k: v.detach().to("cpu", torch.float32, copy=True)
         if isinstance(v, torch.Tensor)
         else torch.from_numpy(np.array(v, np.float32))
         for k, v in state_dict.items()}, assign=True)
    model.to(device)
    for name, param in model.named_parameters():
        if not name.endswith(_F32_SUFFIXES):
            param.data = param.data.to(dtype)
    return model.eval().requires_grad_(False)


def build_group(model: DepthAnythingV2, devices: Sequence) -> ModelGroup:
    """``model`` across a model group of ``len(devices)`` ranks: rank r's
    DepthAnythingV2 holds ``shard_state_dict(model.state_dict(), r, m,
    heads)`` (its shards of the split parameters, every other parameter
    whole) on ``devices[r]``, in the dtypes ``model`` holds them in. Raises
    ValueError where m does not divide the embedding width or the MLP
    hidden (parallel/sharding.check_model_axis)."""
    m = len(devices)
    check_model_axis(model.cfg, m)
    state_dict = model.state_dict()
    ranks = []
    for r, dev in enumerate(devices):
        with torch.device("meta"):
            rank = DepthAnythingV2(model.cfg, dtype=model.dtype,
                                   tail=model.depth_head.tail, group=m,
                                   rank=r)
        rank.load_state_dict(
            {k: v.to(dev, copy=True) for k, v in shard_state_dict(
                state_dict, r, m, model.cfg.num_heads).items()},
            assign=True)
        ranks.append(rank.eval().requires_grad_(False))
    return ModelGroup(ranks)


def load_model(encoder: str, encoder_path: Optional[str] = None,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cuda",
               allow_random: bool = False, seed: int = 0,
               cfg: Optional[ModelConfig] = None,
               tail: str = "auto") -> DepthAnythingV2:
    """Load a checkpoint directory of the port's format
    (:mod:`models.checkpoint`), an official Depth-Anything-V2 ``.pth`` or,
    with ``allow_random``, seeded random weights. A directory takes the
    first branch, as the JAX package's ``load_model`` reads one as its
    Orbax checkpoint: any other directory (an Orbax one, an empty one)
    raises whatever ``allow_random`` is, and never falls through to random
    weights. ``cfg`` overrides the encoder's ModelConfig (e.g.
    RunConfig.model()); ``tail`` is the DPT head's tail path."""
    cfg = cfg or ModelConfig.for_encoder(encoder)
    if encoder_path and os.path.isdir(encoder_path):
        state_dict = checkpoint.load(encoder_path)
    elif encoder_path and os.path.isfile(encoder_path):
        state_dict = torch.load(encoder_path, map_location="cpu",
                                weights_only=True)
    elif allow_random:
        state_dict = random_state_dict(cfg, seed)
    else:
        raise FileNotFoundError(
            f"checkpoint not found: {encoder_path!r}; pass allow_random=True "
            "to run with seeded random weights")
    return build_model(cfg, state_dict, dtype, device, tail=tail)
