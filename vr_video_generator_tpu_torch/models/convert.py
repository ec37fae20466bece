"""JAX parameter tree -> upstream (PyTorch) state_dict.

The exact inverse of vr_video_generator_tpu/models/convert.py
`convert_state_dict`, so the JAX package's parameters can drive this
package's model (the parity tests run both on the same weights). Layouts:
Dense kernel (in, out) -> Linear (out, in); Conv (kh, kw, I, O) ->
(O, I, kh, kw); PixelShuffleUpsample (r, r, I, O) -> ConvTranspose
(I, O, r, r); LayerNorm {scale, bias} -> {weight, bias}.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from vr_video_generator_tpu_torch.utils.config import ModelConfig


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _dense(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = np.ascontiguousarray(_np(p["kernel"]).T)
    if "bias" in p:
        sd[prefix + ".bias"] = _np(p["bias"])


def _conv(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = np.ascontiguousarray(
        _np(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[prefix + ".bias"] = _np(p["bias"])


def _conv_transpose(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = np.ascontiguousarray(
        _np(p["kernel"]).transpose(2, 3, 0, 1))
    sd[prefix + ".bias"] = _np(p["bias"])


def _norm(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _np(p["scale"])
    sd[prefix + ".bias"] = _np(p["bias"])


def _zero_conv(features: int) -> Dict[str, np.ndarray]:
    return {"kernel": np.zeros((3, 3, features, features), np.float32),
            "bias": np.zeros((features,), np.float32)}


def state_dict_from_jax(params: Mapping, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """Flax params tree (numpy or jax arrays) -> upstream state_dict of f32
    numpy arrays. What the JAX tree does not keep (``pretrained.mask_token``
    and refinenet4's unused ``resConfUnit1``) comes back as zeros."""
    sd: Dict[str, np.ndarray] = {}
    pre = params["pretrained"]
    sd["pretrained.cls_token"] = _np(pre["cls_token"])
    sd["pretrained.pos_embed"] = _np(pre["pos_embed"])
    sd["pretrained.mask_token"] = np.zeros((1, cfg.embed_dim), np.float32)
    _conv(sd, "pretrained.patch_embed.proj", pre["patch_embed"])
    _norm(sd, "pretrained.norm", pre["norm"])
    for i in range(cfg.depth):
        blk, p = pre[f"block{i}"], f"pretrained.blocks.{i}"
        _norm(sd, p + ".norm1", blk["norm1"])
        _dense(sd, p + ".attn.qkv", blk["attn"]["qkv"])
        _dense(sd, p + ".attn.proj", blk["attn"]["proj"])
        sd[p + ".ls1.gamma"] = _np(blk["ls1"]["gamma"])
        _norm(sd, p + ".norm2", blk["norm2"])
        dense = ("w12", "w3") if cfg.ffn_layer == "swiglufused" \
            else ("fc1", "fc2")
        for name in dense:
            _dense(sd, f"{p}.mlp.{name}", blk["mlp"][name])
        sd[p + ".ls2.gamma"] = _np(blk["ls2"]["gamma"])

    head = params["depth_head"]
    for i in range(4):
        _conv(sd, f"depth_head.projects.{i}", head[f"project{i}"])
    _conv_transpose(sd, "depth_head.resize_layers.0", head["resize0"])
    _conv_transpose(sd, "depth_head.resize_layers.1", head["resize1"])
    _conv(sd, "depth_head.resize_layers.3", head["resize3"])
    for i in range(4):
        _conv(sd, f"depth_head.scratch.layer{i + 1}_rn", head[f"layer{i + 1}_rn"])
    for i in range(1, 5):
        rn, p = head[f"refinenet{i}"], f"depth_head.scratch.refinenet{i}"
        for unit, name in (("rcu1", "resConfUnit1"), ("rcu2", "resConfUnit2")):
            # refinenet4 takes no skip input, so the JAX tree has no rcu1
            # there; upstream still declares it (zeros here, never used).
            conv = rn.get(unit) or {c: _zero_conv(cfg.features)
                                    for c in ("conv1", "conv2")}
            _conv(sd, f"{p}.{name}.conv1", conv["conv1"])
            _conv(sd, f"{p}.{name}.conv2", conv["conv2"])
        _conv(sd, p + ".out_conv", rn["out_conv"])
    _conv(sd, "depth_head.scratch.output_conv1", head["output_conv1"])
    _conv(sd, "depth_head.scratch.output_conv2.0", head["output_conv2_0"])
    _conv(sd, "depth_head.scratch.output_conv2.2", head["output_conv2_2"])
    return sd
