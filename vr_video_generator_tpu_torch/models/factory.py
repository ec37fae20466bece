"""Model factory: official checkpoints or seeded random weights (numpy)."""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from vr_video_generator_tpu_torch.utils.config import ModelConfig
from vr_video_generator_tpu_torch.models.depth_anything_v2 import DepthAnythingV2

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


def load_model(encoder: str, encoder_path: Optional[str] = None,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cuda",
               allow_random: bool = False, seed: int = 0,
               cfg: Optional[ModelConfig] = None,
               tail: str = "auto") -> DepthAnythingV2:
    """Load an official Depth-Anything-V2 ``.pth`` or, with
    ``allow_random``, seeded random weights. ``cfg`` overrides the
    encoder's ModelConfig (e.g. RunConfig.model()); ``tail`` is the DPT
    head's tail path."""
    cfg = cfg or ModelConfig.for_encoder(encoder)
    if encoder_path and os.path.isfile(encoder_path):
        state_dict = torch.load(encoder_path, map_location="cpu",
                                weights_only=True)
    elif allow_random:
        state_dict = random_state_dict(cfg, seed)
    else:
        raise FileNotFoundError(
            f"checkpoint not found: {encoder_path!r}; pass allow_random=True "
            "to run with seeded random weights")
    return build_model(cfg, state_dict, dtype, device, tail=tail)
