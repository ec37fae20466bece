"""DINOv2 vision transformer encoder (PyTorch), unfused block path.

Mirrors vr_video_generator_tpu/models/dinov2.py with ``mlp_fused="xla"``:
patch embed as one GEMM in the (py, px, c) flatten order, cls token,
bicubic pos-embed resample with the +0.1 offset, pre-norm blocks
(LayerNorm -> qkv -> attention -> proj -> LayerScale, LayerNorm -> MLP with
the A&S GELU -> LayerScale), and final-norm taps. Module and parameter names
are the upstream state_dict names (``pretrained.blocks.{i}.attn.qkv.weight``,
...), so an official checkpoint loads with ``load_state_dict``.

The LayerNorms go through ops/layernorm.py (Triton kernel on CUDA) and the
attention through ops/attention.py (CUDA kernel). Activations are in the
compute dtype; LayerNorm statistics, the pos-embed resample and the softmax
are f32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vr_video_generator_tpu.utils.config import ModelConfig
from vr_video_generator_tpu_torch import not_ported
from vr_video_generator_tpu_torch.ops.attention import mha
from vr_video_generator_tpu_torch.ops.gelu import gelu_exact
from vr_video_generator_tpu_torch.ops.layernorm import layernorm
from vr_video_generator_tpu_torch.ops.resize import resize_bicubic


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
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        head_dim = c // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, head_dim)
        out = mha(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                  scale=head_dim ** -0.5)
        return self.proj(out.reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_exact(self.fc1(x)))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    """x + ls1(attn(norm1 x)); x + ls2(mlp(norm2 x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    """14x14/s14 patch conv, computed as patch extraction + one GEMM."""

    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, ph*pw, D)."""
        b, h, w, _ = x.shape
        p = self.patch
        ph, pw = h // p, w // p
        patches = x.reshape(b, ph, p, pw, p, 3).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(b, ph * pw, p * p * 3)
        weight = self.proj.weight.permute(0, 2, 3, 1).reshape(-1, p * p * 3)
        return F.linear(patches, weight, self.proj.bias)


class DinoVisionTransformer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.ffn_layer != "mlp":
            not_ported(f"ffn_layer={cfg.ffn_layer!r} (vitg)",
                       "SwiGLU encoder (vitg)")
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
            Block(d, cfg.num_heads, cfg.mlp_ratio) for _ in range(cfg.depth))
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
