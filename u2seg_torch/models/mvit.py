"""MViTv2 trunk (counterpart of ``u2seg_tpu/models/mvit.py``).

Pooling attention on (B, H, W, C) token maps: q, k and v are linear maps
average-pooled by their strides (flax's ``avg_pool``, floor sizes), global
attention between the pooled q and the pooled k/v, the residual ``out + q``
(MViTv2's residual pooling), a projection. The first block of every stage
after the first pools q by 2 and doubles the width (its shortcut pooled and
projected); k and v pool by 2 in every stage but the last. Stage 0 attends
from every stride-4 token to a quarter of them: its scores grow with the
square of the image's area.

The trunk computes in f32 whatever its input's dtype (the JAX package builds
it with no dtype). Names: ``patch_embed.proj``, ``blocks.{n}.{norm1,attn.{q,
k,v,proj},shortcut_proj,norm2,mlp.fc1,mlp.fc2}`` numbered across stages, and
``res{k}_norm``.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from u2seg_torch.models.vit import Mlp, attention


def _pool_hw(x: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, H, W, C) average-pooled by ``stride`` (floor sizes; 1: x)."""
    if stride == 1:
        return x
    return F.avg_pool2d(x.permute(0, 3, 1, 2), stride, stride).permute(0, 2, 3, 1)


class PoolingAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int,
                 q_stride: int = 1, kv_stride: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.q_stride, self.kv_stride = q_stride, kv_stride
        self.q = nn.Linear(dim, dim_out)
        self.k = nn.Linear(dim, dim_out)
        self.v = nn.Linear(dim, dim_out)
        self.proj = nn.Linear(dim_out, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = _pool_hw(self.q(x), self.q_stride)
        k = _pool_hw(self.k(x), self.kv_stride)
        v = _pool_hw(self.v(x), self.kv_stride)
        b, qh, qw, c = q.shape

        def heads(t):
            return t.reshape(b, -1, self.num_heads, c // self.num_heads).transpose(1, 2)

        out = attention(heads(q), heads(k), heads(v))
        out = out.transpose(1, 2).reshape(b, qh, qw, c)
        return self.proj(out + q)                   # residual pooling


class MViTBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int, q_stride: int = 1,
                 kv_stride: int = 1, mlp_ratio: float = 4.0):
        super().__init__()
        self.q_stride = q_stride
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = PoolingAttention(dim, dim_out, num_heads, q_stride, kv_stride)
        self.shortcut_proj = nn.Linear(dim, dim_out) if dim != dim_out else None
        self.norm2 = nn.LayerNorm(dim_out, eps=1e-6)
        self.mlp = Mlp(dim_out, int(dim_out * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = self.attn(self.norm1(x))
        shortcut = _pool_hw(x, self.q_stride)
        if self.shortcut_proj is not None:
            shortcut = self.shortcut_proj(shortcut)
        x = shortcut + attn
        return x + self.mlp(self.norm2(x))


class MViT(nn.Module):
    """MViTv2-T-ish by default: stages of depth (1, 2, 5, 2), widths 96-768.
    Returns {"res2".."res5"} NCHW f32 maps in channels-last memory;
    ``channels`` gives each level's width."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (1, 2, 5, 2),
                 num_heads: Sequence[int] = (1, 2, 4, 8), patch_size: int = 4,
                 out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")):
        super().__init__()
        self.out_features = tuple(out_features)
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, embed_dim, 7, stride=patch_size, padding=3)
        self.blocks = nn.ModuleList()
        self.stage_ends = []
        self.channels: Dict[str, int] = {}
        dim = dim_in = embed_dim
        for stage, (d, heads) in enumerate(zip(depths, num_heads)):
            for i in range(d):
                self.blocks.append(MViTBlock(
                    dim_in, dim, heads, q_stride=2 if i == 0 and stage > 0 else 1,
                    kv_stride=2 if stage < len(depths) - 1 else 1))
                dim_in = dim
            self.stage_ends.append(len(self.blocks))
            name = f"res{stage + 2}"
            if name in self.out_features:
                self.add_module(f"{name}_norm", nn.LayerNorm(dim, eps=1e-6))
                self.channels[name] = dim
            dim *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.patch_embed.proj(x.float()).permute(0, 2, 3, 1)
        out, start = {}, 0
        for stage, end in enumerate(self.stage_ends):
            for blk in self.blocks[start:end]:
                x = blk(x)
            start = end
            name = f"res{stage + 2}"
            if name in self.out_features:
                out[name] = getattr(self, f"{name}_norm")(x).permute(0, 3, 1, 2)
        return out
