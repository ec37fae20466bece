"""DINOv2 vision transformer encoder (PyTorch).

Mirrors vr_video_generator_tpu/models/dinov2.py: patch embed as one GEMM in
the (py, px, c) flatten order, cls token, bicubic pos-embed resample with
the +0.1 offset, pre-norm blocks (LayerNorm -> qkv -> attention -> proj ->
LayerScale, LayerNorm -> MLP with the A&S GELU (the tanh GELU with
``gelu_approx``), or vitg's SwiGLU ->
LayerScale), and final-norm taps. Module and parameter names are the
upstream state_dict names (``pretrained.blocks.{i}.attn.qkv.weight``,
``...mlp.w12.weight``), so an official checkpoint loads with
``load_state_dict``.

``mlp_fused`` picks each half-block's path as the JAX package does, with
CUDA in the TPU's place (:func:`resolve_block_fusion`). Unfused, the
LayerNorms go through ops/layernorm.py (the CUDA kernel on CUDA) and the
attention through ops/attention.mha (the one-shot CUDA kernel up to 4096
tokens, the flash kernel above). Fused, the attention half is
ops/qkv.ln_qkv -> attention -> ops/qkv.proj_ls_residual (up to 4096 tokens,
where the JAX package plans it) and the MLP half is ops/mlp.mlp_residual
(vits, vitb), ops/mlp.mlp_residual_hblocked (vitl), as the JAX package picks
its resident or hidden-blocked kernel (at f32 by f32's weight bytes: vits
resident, vitb and vitl hidden-blocked), or ops/mlp.swiglu_residual (vitg),
reading the same parameters. Activations are in the compute dtype;
LayerNorm statistics, the pos-embed resample and the softmax are f32; dense
layers round as flax's (models/layers.py).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vr_video_generator_tpu_torch.utils.config import ModelConfig
from vr_video_generator_tpu_torch import not_ported
from vr_video_generator_tpu_torch.models.layers import Conv2d, Linear
from vr_video_generator_tpu_torch.ops import mlp as mlp_ops
from vr_video_generator_tpu_torch.ops import qkv as qkv_ops
from vr_video_generator_tpu_torch.ops.attention import (attention, mha,
                                                        oneshot_supported)
from vr_video_generator_tpu_torch.ops.layernorm import layernorm
from vr_video_generator_tpu_torch.ops.mlp import (mlp_residual,
                                                  mlp_residual_hblocked,
                                                  silu_mul, swiglu_hidden,
                                                  swiglu_residual)
from vr_video_generator_tpu_torch.ops.qkv import ln_qkv, proj_ls_residual
from vr_video_generator_tpu_torch.ops.resize import resize_bicubic
from vr_video_generator_tpu_torch.parallel.collectives import (all_reduce_,
                                                               device_scope)
from vr_video_generator_tpu_torch.parallel.sharding import (head_range,
                                                            unshard)


def kernel_device(x: torch.Tensor) -> str:
    """The device type ``auto`` resolves for: "cuda" for bf16 or f32
    activations on the card (the kernels and their f32 variants), else
    "cpu"."""
    return "cuda" if x.is_cuda and x.dtype in (torch.bfloat16,
                                               torch.float32) else "cpu"


def resolve_block_fusion(mlp_fused: str, dim: int, num_heads: int,
                         n_tokens: int, device_type: str, dtype: torch.dtype,
                         ffn_layer: str = "mlp") -> Tuple[bool, bool]:
    """(fuse the attention half, fuse the MLP half) of a block over
    ``n_tokens`` tokens in ``dtype``, as the JAX package resolves
    ``mlp_fused`` (its models/dinov2.py Block) with CUDA in the TPU's place.
    The attention half fuses where the JAX Block fuses it: head dim 64, at
    most 4096 tokens (attention_pallas.supported; above, LayerNorm -> qkv ->
    flash attention -> proj) and where qkv_pallas.attn_fusable plans its
    resident weights (:func:`ops.qkv.attn_fusable`: not at D=1024 in f32,
    nor at vitg's D=1536), and only at a width the qkv kernels take.
    ``auto`` fuses the attention half there and the MLP half at D >= 512, on
    CUDA only (``device_type`` is :func:`kernel_device`'s: bf16 or f32 on
    the card; at f32 ``attn_fusable`` leaves vitl's D = 1024 unfused); off
    the card it fuses nothing, as the JAX package's ``auto`` does off the
    TPU. ``fused`` fuses both wherever the JAX package would (off the
    card through the plain versions); where either would fuse the MLP half
    (``ffn_layer`` "mlp" or vitg's "swiglufused") at a width no kernel takes
    in ``dtype``, it raises; ``xla`` fuses nothing."""
    if mlp_fused not in ("auto", "fused", "xla"):
        raise ValueError(f"mlp_fused must be auto, fused or xla, got "
                         f"{mlp_fused!r}")
    on_card = device_type == "cuda"
    want = mlp_fused == "fused" or (mlp_fused == "auto" and on_card)
    attn = want and dim in qkv_ops.WIDTHS \
        and dim == num_heads * qkv_ops.HEAD_DIM and oneshot_supported(n_tokens) \
        and qkv_ops.attn_fusable(dim, n_tokens, dtype)
    mlp = dim % 128 == 0 and (mlp_fused == "fused" or (
        mlp_fused == "auto" and on_card and dim >= 512))
    if mlp and not mlp_ops.takes_width(dim, ffn_layer, dtype):
        not_ported(f"mlp_fused={mlp_fused!r} at D={dim} ({ffn_layer})",
                   "fused MLP kernels at other widths")
    return attn, mlp


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm parameters (kept f32), eps 1e-6, run through the
    LayerNorm kernel with output in the input's dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.weight, self.bias, eps=self.eps)


class Attention(nn.Module):
    """qkv -> attention -> proj. On a model group of ``group`` ranks rank
    ``rank`` holds its shards (parallel/sharding.py): qkv's rows of its
    ``num_heads`` heads (sharding.head_range: maybe unequal across ranks,
    or none) and proj's columns of them."""

    def __init__(self, dim: int, num_heads: int, group: int = 1,
                 rank: int = 0):
        super().__init__()
        lo, hi = head_range(rank, group, num_heads)
        self.num_heads = hi - lo
        width = self.num_heads * (dim // num_heads)
        self.qkv = Linear(dim, 3 * width)
        self.proj = Linear(width, dim)

    def heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, D) -> this rank's heads' outputs, (B, N, heads x
        head_dim)."""
        b, n, _ = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, -1)
        head_dim = qkv.shape[-1]
        out = mha(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                  scale=head_dim ** -0.5)
        return out.reshape(b, n, -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self.heads(x))


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2: the A&S GELU, or with ``gelu_approx`` the tanh
    GELU (``ModelConfig.gelu_approx``, ``--gelu tanh``). On a model group
    this rank holds fc1's rows and fc2's columns of its hidden slice."""

    def __init__(self, dim: int, hidden: int, gelu_approx: bool = False,
                 group: int = 1):
        super().__init__()
        self.gelu_approx = gelu_approx
        self.fc1 = Linear(dim, hidden // group)
        self.fc2 = Linear(hidden // group, dim)

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_ops.gelu(self.fc1(x), self.gelu_approx)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.hidden(x))


class SwiGLUFFN(nn.Module):
    """vitg's SwiGLUFFNFused: one Linear gives [x1 | x2], then
    w3(silu(x1) * x2), hidden :func:`ops.mlp.swiglu_hidden`."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w12 = Linear(dim, 2 * hidden)
        self.w3 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(silu_mul(x1, x2))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    """x + ls1(attn(norm1 x)); x + ls2(mlp(norm2 x)), each half unfused or
    through its fused kernels (:func:`resolve_block_fusion`), with the same
    parameters either way. A Block of a model group (``group`` > 1) holds
    rank ``rank``'s shards and runs through :func:`group_block`."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 mlp_fused: str = "auto", ffn_layer: str = "mlp",
                 gelu_approx: bool = False, group: int = 1, rank: int = 0):
        super().__init__()
        self.dim, self.num_heads, self.mlp_fused = dim, num_heads, mlp_fused
        self.ffn_layer, self.group = ffn_layer, group
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, group, rank)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim)
        if ffn_layer == "swiglufused":
            self.mlp = SwiGLUFFN(dim, swiglu_hidden(dim, mlp_ratio))
        elif ffn_layer == "mlp":
            self.mlp = Mlp(dim, int(dim * mlp_ratio), gelu_approx, group)
        else:
            raise ValueError(f"ffn_layer must be mlp or swiglufused, got "
                             f"{ffn_layer!r}")
        self.ls2 = LayerScale(dim)
        # A group rank's whole split weights, gathered from the group at the
        # first fused half that takes them (group_block).
        self.whole: Dict[str, torch.Tensor] = {}

    def fusion(self, x: torch.Tensor) -> Tuple[bool, bool]:
        return resolve_block_fusion(
            self.mlp_fused, self.dim, self.num_heads, x.shape[1],
            kernel_device(x), x.dtype, self.ffn_layer)

    def fused_attn(self, x: torch.Tensor, qkv_w: torch.Tensor,
                   qkv_b: torch.Tensor, proj_w: torch.Tensor) -> torch.Tensor:
        qkv = ln_qkv(x, self.norm1.weight, self.norm1.bias, qkv_w, qkv_b,
                     self.num_heads, (self.dim // self.num_heads) ** -0.5,
                     eps=self.norm1.eps)
        o = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return proj_ls_residual(o, x, proj_w, self.attn.proj.bias,
                                self.ls1.gamma)

    def fused_mlp(self, x: torch.Tensor, fc1_w=None, fc1_b=None,
                  fc2_w=None) -> torch.Tensor:
        """The fused MLP half; ``fc1_w``, ``fc1_b``, ``fc2_w``: the whole
        fc1 and fc2 weights (unused by vitg's SwiGLU half)."""
        if self.ffn_layer == "swiglufused":
            return swiglu_residual(x, self.norm2.weight, self.norm2.bias,
                                   self.mlp.w12.weight, self.mlp.w12.bias,
                                   self.mlp.w3.weight, self.mlp.w3.bias,
                                   self.ls2.gamma, eps=self.norm2.eps)
        half = mlp_residual if mlp_ops.resident(
            self.dim, fc1_w.shape[0], x.dtype) else mlp_residual_hblocked
        return half(x, self.norm2.weight, self.norm2.bias, fc1_w, fc1_b,
                    fc2_w, self.mlp.fc2.bias, self.ls2.gamma,
                    eps=self.norm2.eps, approx=self.mlp.gelu_approx)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.group > 1:
            raise RuntimeError("a Block of a model group runs through "
                               "group_block")
        fuse_attn, fuse_mlp = self.fusion(x)
        if fuse_attn:
            x = self.fused_attn(x, self.attn.qkv.weight, self.attn.qkv.bias,
                                self.attn.proj.weight)
        else:
            x = x + self.ls1(self.attn(self.norm1(x)))
        if not fuse_mlp:
            return x + self.ls2(self.mlp(self.norm2(x)))
        if self.ffn_layer == "swiglufused":
            return self.fused_mlp(x)
        return self.fused_mlp(x, self.mlp.fc1.weight, self.mlp.fc1.bias,
                              self.mlp.fc2.weight)


# The split parameters each fused half takes whole (parallel/sharding.py).
_ATTN_SPLIT = ("attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight")
_MLP_SPLIT = ("mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight")


def _whole(blocks: Sequence[Block], rank: int, names: Sequence[str]
           ) -> List[torch.Tensor]:
    """Rank ``rank``'s whole copies of the split ``names``, gathered from
    every rank's shard onto its device once and kept: the all-gather XLA
    puts before a Pallas call, which it does not partition."""
    blk = blocks[rank]
    if names[0] not in blk.whole:
        dev = blk.norm1.weight.device
        params = [dict(b.named_parameters()) for b in blocks]
        # Normal tensors, as parameters are: the kernels' wrappers keep
        # per-weight caches (ops/mlp.tf32x3_weight) only on tensors with a
        # version counter, which inference tensors lack.
        with torch.inference_mode(False):
            for name in names:
                blk.whole[name] = unshard(name, [p[name].to(dev)
                                                 for p in params])
    return [blk.whole[name] for name in names]


def _on_ranks(blocks: Sequence[Block], xs: Sequence[torch.Tensor],
              fn) -> List[torch.Tensor]:
    """[fn(r, blocks[r], xs[r])] with each rank's device current."""
    out = []
    for r, (b, x) in enumerate(zip(blocks, xs)):
        with device_scope(x.device):
            out.append(fn(r, b, x))
    return out


def group_block(blocks: Sequence[Block], xs: List[torch.Tensor]
                ) -> List[torch.Tensor]:
    """One Block across a model group: ``blocks[r]`` is rank r's Block on its
    device and ``xs[r]`` the tokens there (equal on every rank). A fused
    half runs its kernels on whole weights on every rank, as at 1 x 1. An
    unfused half runs each rank's shards: LayerNorm -> its qkv rows -> mha
    at its heads (sharding.head_range) -> its proj columns, or fc1 rows +
    their bias -> GELU -> fc2 columns, each without the replicated bias;
    then one all-reduce, and the bias once after the sum, LayerScale and the
    residual. A rank with no heads runs no qkv, attention or proj: its
    attention partial is zeros, and it joins the all-reduce. The
    partials are rounded to the compute dtype and summed in it, as XLA
    all-reduces the dot's output. vitg's SwiGLU half is replicated by the
    rules, so every rank runs it whole."""
    fuse_attn, fuse_mlp = blocks[0].fusion(xs[0])
    if fuse_attn:
        xs = _on_ranks(blocks, xs, lambda r, b, x: b.fused_attn(
            x, *_whole(blocks, r, _ATTN_SPLIT)))
    else:
        parts = _on_ranks(blocks, xs, lambda r, b, x: F.linear(
            b.attn.heads(b.norm1(x)), b.attn.proj.weight)
            if b.attn.num_heads else torch.zeros_like(x))
        all_reduce_(parts)
        xs = _on_ranks(blocks, xs, lambda r, b, x: x + b.ls1(
            parts[r] + b.attn.proj.bias.to(x.dtype)))
    if blocks[0].ffn_layer == "swiglufused":
        return _on_ranks(blocks, xs, lambda r, b, x: b.fused_mlp(x)
                         if fuse_mlp else x + b.ls2(b.mlp(b.norm2(x))))
    if fuse_mlp:
        return _on_ranks(blocks, xs, lambda r, b, x: b.fused_mlp(
            x, *_whole(blocks, r, _MLP_SPLIT)))
    parts = _on_ranks(blocks, xs, lambda r, b, x: F.linear(
        b.mlp.hidden(b.norm2(x)), b.mlp.fc2.weight))
    all_reduce_(parts)
    return _on_ranks(blocks, xs, lambda r, b, x: x + b.ls2(
        parts[r] + b.mlp.fc2.bias.to(x.dtype)))


class PatchEmbed(nn.Module):
    """14x14/s14 patch conv, computed as patch extraction + one GEMM."""

    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.patch = patch
        self.proj = Conv2d(3, dim, patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, ph*pw, D)."""
        b, h, w, _ = x.shape
        p = self.patch
        ph, pw = h // p, w // p
        patches = x.reshape(b, ph, p, pw, p, 3).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(b, ph * pw, p * p * 3)
        weight = self.proj.weight.permute(0, 2, 3, 1).reshape(-1, p * p * 3)
        y = F.linear(patches, weight)
        return y + self.proj.bias.to(y.dtype)


class DinoVisionTransformer(nn.Module):
    def __init__(self, cfg: ModelConfig, group: int = 1, rank: int = 0):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        grid = cfg.pretrain_img_size // cfg.patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, d))
        # Upstream keeps a mask token for masked pretraining; unused here,
        # declared so official checkpoints load strictly.
        self.mask_token = nn.Parameter(torch.zeros(1, d))
        self.patch_embed = PatchEmbed(cfg.patch_size, d)
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, cfg.mlp_ratio, cfg.mlp_fused,
                  cfg.ffn_layer, cfg.gelu_approx, group, rank)
            for _ in range(cfg.depth))
        self.norm = LayerNorm(d)

    def interpolate_pos_encoding(self, ph: int, pw: int) -> torch.Tensor:
        """Bicubic pos-embed resample to a (ph, pw) grid in f32; identity
        when the grid is the pretraining one."""
        pos = self.pos_embed.float()
        side = int(round((pos.shape[1] - 1) ** 0.5))
        if ph == pw == side:
            return pos
        off = self.cfg.interpolate_offset
        grid = pos[:, 1:].reshape(1, side, side, -1)
        grid = resize_bicubic(grid, (ph, pw), align_corners=False,
                              scale_hw=((ph + off) / side, (pw + off) / side),
                              h_axis=1, w_axis=2)
        return torch.cat([pos[:, :1], grid.reshape(1, ph * pw, -1)], dim=1)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) normalized, H and W multiples of 14 -> the tokens
        (B, 1 + ph*pw, D): the patch embedding, the cls token and the
        resampled pos-embed."""
        b, h, w, _ = x.shape
        p = self.cfg.patch_size
        tokens = self.patch_embed(x)
        cls = self.cls_token.to(tokens.dtype).expand(b, -1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        pos = self.interpolate_pos_encoding(h // p, w // p)
        return tokens + pos.to(tokens.dtype)

    def tap(self, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(patch tokens, cls token) after the final norm."""
        out = self.norm(tokens)
        return out[:, 1:], out[:, 0]

    def forward(self, x: torch.Tensor, take_layers: Sequence[int]
                ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
        """x (B, H, W, 3) normalized, H and W multiples of 14 -> per tapped
        layer (patch tokens (B, ph*pw, D), cls token (B, D)) after the final
        norm."""
        tokens = self.embed(x)
        take = set(take_layers)
        tapped = {}
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            if i in take:
                tapped[i] = self.tap(tokens)
        return tuple(tapped[i] for i in take_layers)
