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
its resident or hidden-blocked kernel, or ops/mlp.swiglu_residual (vitg),
reading the same parameters. Activations are in the compute dtype;
LayerNorm statistics, the pos-embed resample and the softmax are f32; dense
layers round as flax's (models/layers.py).
"""

from __future__ import annotations

from typing import Sequence, Tuple

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
    (``ffn_layer`` "mlp" or vitg's "swiglufused") at a width no kernel takes,
    it raises; ``xla`` fuses nothing."""
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
    if mlp and not mlp_ops.takes_width(dim, ffn_layer):
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
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        head_dim = c // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, head_dim)
        out = mha(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                  scale=head_dim ** -0.5)
        return self.proj(out.reshape(b, n, c))


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2: the A&S GELU, or with ``gelu_approx`` the tanh
    GELU (``ModelConfig.gelu_approx``, ``--gelu tanh``)."""

    def __init__(self, dim: int, hidden: int, gelu_approx: bool = False):
        super().__init__()
        self.gelu_approx = gelu_approx
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(mlp_ops.gelu(self.fc1(x), self.gelu_approx))


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
    parameters either way."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 mlp_fused: str = "auto", ffn_layer: str = "mlp",
                 gelu_approx: bool = False):
        super().__init__()
        self.dim, self.num_heads, self.mlp_fused = dim, num_heads, mlp_fused
        self.ffn_layer = ffn_layer
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim)
        if ffn_layer == "swiglufused":
            self.mlp = SwiGLUFFN(dim, swiglu_hidden(dim, mlp_ratio))
        elif ffn_layer == "mlp":
            self.mlp = Mlp(dim, int(dim * mlp_ratio), gelu_approx)
        else:
            raise ValueError(f"ffn_layer must be mlp or swiglufused, got "
                             f"{ffn_layer!r}")
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fuse_attn, fuse_mlp = resolve_block_fusion(
            self.mlp_fused, self.dim, self.num_heads, x.shape[1],
            kernel_device(x), x.dtype, self.ffn_layer)
        if fuse_attn:
            qkv = ln_qkv(x, self.norm1.weight, self.norm1.bias,
                         self.attn.qkv.weight, self.attn.qkv.bias,
                         self.num_heads, (self.dim // self.num_heads) ** -0.5,
                         eps=self.norm1.eps)
            o = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
            x = proj_ls_residual(o, x, self.attn.proj.weight,
                                 self.attn.proj.bias, self.ls1.gamma)
        else:
            x = x + self.ls1(self.attn(self.norm1(x)))
        if fuse_mlp and self.ffn_layer == "swiglufused":
            return swiglu_residual(x, self.norm2.weight, self.norm2.bias,
                                   self.mlp.w12.weight, self.mlp.w12.bias,
                                   self.mlp.w3.weight, self.mlp.w3.bias,
                                   self.ls2.gamma, eps=self.norm2.eps)
        if fuse_mlp:
            half = mlp_residual if mlp_ops.resident(
                self.dim, self.mlp.fc1.weight.shape[0], x.dtype) \
                else mlp_residual_hblocked
            return half(x, self.norm2.weight, self.norm2.bias,
                        self.mlp.fc1.weight, self.mlp.fc1.bias,
                        self.mlp.fc2.weight, self.mlp.fc2.bias,
                        self.ls2.gamma, eps=self.norm2.eps,
                        approx=self.mlp.gelu_approx)
        return x + self.ls2(self.mlp(self.norm2(x)))


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
    def __init__(self, cfg: ModelConfig):
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
                  cfg.ffn_layer, cfg.gelu_approx)
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

    def forward(self, x: torch.Tensor, take_layers: Sequence[int]
                ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
        """x (B, H, W, 3) normalized, H and W multiples of 14 -> per tapped
        layer (patch tokens (B, ph*pw, D), cls token (B, D)) after the final
        norm."""
        b, h, w, _ = x.shape
        p = self.cfg.patch_size
        ph, pw = h // p, w // p
        tokens = self.patch_embed(x)
        cls = self.cls_token.to(tokens.dtype).expand(b, -1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + self.interpolate_pos_encoding(ph, pw).to(tokens.dtype)

        take = set(take_layers)
        tapped = {}
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            if i in take:
                out = self.norm(tokens)
                tapped[i] = (out[:, 1:], out[:, 0])
        return tuple(tapped[i] for i in take_layers)
