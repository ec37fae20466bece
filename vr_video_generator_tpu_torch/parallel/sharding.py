"""Parameter partition rules: tensor parallelism in the depth net (PyTorch).

Mirrors vr_video_generator_tpu/parallel/sharding.py: Megatron-style head and
hidden sharding of the DINOv2 blocks over the ``model`` mesh axis. qkv and
fc1 split their output features, proj and fc2 their input features, so each
split half-block needs one all-reduce (parallel/collectives.py, where XLA
inserts it in the JAX package). Everything else (norms, embeddings,
LayerScale, the proj and fc2 biases, vitg's SwiGLU ``w12``/``w3`` and the
whole DPT head) is replicated. The names are the port's state_dict names,
in torch's (out, in) layout: "output features" are a weight's rows.

A model axis of M is refused exactly where the JAX package's
``jax.device_put`` of these shardings refuses: where M does not divide D
(qkv's 3D columns, proj's D rows) or, for an MLP (not vitg's replicated
SwiGLU), its hidden width. The heads need not divide: M may exceed them.

Two departures from the JAX package, each the same function with other
partial sums:
- Rank r's qkv shard is the q, k and v rows of its heads, and its proj
  shard the columns of them, so its qkv output reshapes to (3, heads,
  head_dim) as the whole one does. The JAX package splits the 3D columns
  contiguously and lets XLA reshard before the attention.
- Rank r holds the balanced, contiguous head range [floor(r H / M),
  floor((r + 1) H / M)) (:func:`head_range`), so ranks may hold unequal head
  counts, or none where M > H. The JAX package splits qkv's 3D and proj's D
  evenly over M whatever the heads. A rank with no heads runs no attention
  and adds a zero partial to the all-reduce.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

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
    """Raise ValueError where the JAX package's ``device_put`` of the rules
    would refuse ``m`` model ranks: ``m`` not dividing the embedding width
    (qkv's 3D columns, proj's D rows) or, for an MLP, its hidden width
    (vitg's SwiGLU is replicated). The head count is not a constraint: a
    rank holds :func:`head_range`'s heads, maybe none."""
    if m < 1:
        raise ValueError(f"model axis must be >= 1, got {m}")
    hidden = int(cfg.embed_dim * cfg.mlp_ratio)
    if cfg.embed_dim % m:
        raise ValueError(f"a model axis of {m} does not divide {cfg.encoder}'s "
                         f"embedding width {cfg.embed_dim} (qkv's "
                         f"{3 * cfg.embed_dim} columns, proj's "
                         f"{cfg.embed_dim} rows)")
    if cfg.ffn_layer == "mlp" and hidden % m:
        raise ValueError(f"a model axis of {m} does not divide {cfg.encoder}'s "
                         f"MLP hidden {hidden}")


def head_range(rank: int, m: int, num_heads: int) -> Tuple[int, int]:
    """The heads [lo, hi) rank ``rank`` of ``m`` holds: a balanced,
    contiguous range, floor(r H / m) to floor((r + 1) H / m); empty where
    ``m`` exceeds the heads and the rank falls between two of them."""
    return rank * num_heads // m, (rank + 1) * num_heads // m


def _is_qkv(name: str) -> bool:
    return name.endswith(("attn.qkv.weight", "attn.qkv.bias"))


def _is_proj(name: str) -> bool:
    return name.endswith("attn.proj.weight")


def shard(name: str, x, rank: int, m: int, num_heads: int):
    """Rank ``rank``'s shard of parameter ``name`` (a tensor or numpy
    array), a copy; the whole parameter where the rules replicate it. qkv's
    rows and proj's columns are those of the rank's :func:`head_range` of
    ``num_heads``; fc1's rows and fc2's columns split evenly."""
    dim = spec_for(name)
    if dim is None or m == 1:
        return x
    n = x.shape[dim]
    if _is_qkv(name) or _is_proj(name):
        width = n // 3 if _is_qkv(name) else n
        if width % num_heads or (_is_qkv(name) and n % 3):
            raise ValueError(f"{name}: dim {dim} of {n} does not hold "
                             f"{num_heads} heads")
        head_dim = width // num_heads
        lo, hi = (h * head_dim for h in head_range(rank, m, num_heads))
        if _is_qkv(name):
            out = x.reshape(3, width, *x.shape[1:])[:, lo:hi]
            out = out.reshape(3 * (hi - lo), *x.shape[1:])
        else:
            out = x[:, lo:hi]
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
    or numpy arrays), in rank order: the inverse of :func:`shard`."""
    dim, m = spec_for(name), len(shards)
    if dim is None or m == 1:
        return shards[0]
    cat = torch.cat if isinstance(shards[0], torch.Tensor) else np.concatenate
    if _is_qkv(name):
        rest = tuple(shards[0].shape[1:])
        groups = [s.reshape(3, s.shape[0] // 3, *rest) for s in shards]
        return cat(groups, 1).reshape(-1, *rest)
    return cat(list(shards), dim)


def shard_state_dict(state_dict: Mapping, rank: int, m: int,
                     num_heads: int) -> Dict:
    """Rank ``rank``'s state_dict on an ``m``-wide model axis of an encoder
    with ``num_heads`` heads: its shard of every split parameter, every
    other parameter whole."""
    if not 0 <= rank < m:
        raise ValueError(f"rank {rank} is not in a model axis of {m}")
    return {name: shard(name, x, rank, m, num_heads)
            for name, x in state_dict.items()}


def gather_state_dict(shards: Sequence[Mapping]) -> Dict:
    """The whole state_dict from every rank's (:func:`shard_state_dict`)."""
    return {name: unshard(name, [sd[name] for sd in shards])
            for name in shards[0]}
