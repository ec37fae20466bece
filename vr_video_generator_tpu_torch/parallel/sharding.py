"""Parameter partition rules: tensor parallelism in the depth net (PyTorch).

Mirrors vr_video_generator_tpu/parallel/sharding.py: Megatron-style head and
hidden sharding of the DINOv2 blocks over the ``model`` mesh axis. qkv and
fc1 split their output features, proj and fc2 their input features, so each
split half-block needs one all-reduce (parallel/collectives.py, where XLA
inserts it in the JAX package). Everything else (norms, embeddings,
LayerScale, the proj and fc2 biases, vitg's SwiGLU ``w12``/``w3`` and the
whole DPT head) is replicated. The names are the port's state_dict names,
in torch's (out, in) layout: "output features" are a weight's rows.

One departure: rank r's qkv shard is the q, k and v rows of heads
[r H/m, (r + 1) H/m), so its output reshapes to (3, H/m, head_dim) as the
whole one does. The JAX package splits the 3D columns contiguously and lets
XLA reshard before the attention; the products are the same.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from vr_video_generator_tpu_torch.utils.config import ModelConfig

# (state_dict name suffix, the dim split over ``model``) - first match wins.
_TP_RULES = (
    ("attn.qkv.weight", 0),
    ("attn.qkv.bias", 0),
    ("attn.proj.weight", 1),
    ("mlp.fc1.weight", 0),
    ("mlp.fc1.bias", 0),
    ("mlp.fc2.weight", 1),
)


def spec_for(name: str) -> Optional[int]:
    """The dim of parameter ``name`` split over ``model``; None: replicated."""
    for suffix, dim in _TP_RULES:
        if name == suffix or name.endswith("." + suffix):
            return dim
    return None


def param_specs(state_dict: Mapping) -> Dict[str, Optional[int]]:
    """{name: split dim or None} over ``state_dict``'s names."""
    return {name: spec_for(name) for name in state_dict}


def check_model_axis(cfg: ModelConfig, m: int) -> None:
    """Raise ValueError where ``m`` model ranks cannot split the encoder's
    heads or its MLP hidden (vitg's SwiGLU hidden is replicated)."""
    if m < 1:
        raise ValueError(f"model axis must be >= 1, got {m}")
    hidden = int(cfg.embed_dim * cfg.mlp_ratio)
    if cfg.num_heads % m or (cfg.ffn_layer == "mlp" and hidden % m):
        raise ValueError(
            f"a model axis of {m} does not divide {cfg.encoder}'s "
            f"{cfg.num_heads} heads" + (f" and MLP hidden {hidden}"
                                       if cfg.ffn_layer == "mlp" else ""))


def _is_qkv(name: str) -> bool:
    return name.endswith(("attn.qkv.weight", "attn.qkv.bias"))


def shard(name: str, x, rank: int, m: int):
    """Rank ``rank``'s shard of parameter ``name`` (a tensor or numpy
    array), a copy; the whole parameter where the rules replicate it."""
    dim = spec_for(name)
    if dim is None or m == 1:
        return x
    n = x.shape[dim]
    if _is_qkv(name):
        if n % (3 * m):
            raise ValueError(f"{name}: {n} rows do not split into q, k, v "
                             f"over {m} ranks")
        parts = x.reshape(3, m, n // (3 * m), *x.shape[1:])[:, rank]
        out = parts.reshape(n // m, *x.shape[1:])
    else:
        if n % m:
            raise ValueError(f"{name}: dim {dim} of {n} does not split over "
                             f"{m} ranks")
        k = n // m
        out = x[k * rank:k * (rank + 1)] if dim == 0 \
            else x[:, k * rank:k * (rank + 1)]
    return out.clone() if isinstance(out, torch.Tensor) \
        else np.ascontiguousarray(out)


def unshard(name: str, shards: Sequence):
    """The whole parameter from every rank's shard (tensors on one device,
    or numpy arrays): the inverse of :func:`shard`."""
    dim, m = spec_for(name), len(shards)
    if dim is None or m == 1:
        return shards[0]
    cat = torch.cat if isinstance(shards[0], torch.Tensor) else np.concatenate
    if _is_qkv(name):
        n = shards[0].shape[0]
        groups = [s.reshape(3, 1, n // 3, *s.shape[1:]) for s in shards]
        whole = cat(groups, 1)
        return whole.reshape(n * m, *shards[0].shape[1:])
    return cat(list(shards), dim)


def shard_state_dict(state_dict: Mapping, rank: int, m: int) -> Dict:
    """Rank ``rank``'s state_dict on an ``m``-wide model axis: its shard of
    every split parameter, every other parameter whole."""
    if not 0 <= rank < m:
        raise ValueError(f"rank {rank} is not in a model axis of {m}")
    return {name: shard(name, x, rank, m) for name, x in state_dict.items()}


def gather_state_dict(shards: Sequence[Mapping]) -> Dict:
    """The whole state_dict from every rank's (:func:`shard_state_dict`)."""
    return {name: unshard(name, [sd[name] for sd in shards])
            for name in shards[0]}
