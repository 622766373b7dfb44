"""ViTDet: a plain ViT trunk and its SimpleFeaturePyramid (counterpart of
``u2seg_tpu/models/vit.py``).

The trunk works on (B, H, W, C) token maps as the JAX module does: a p x p
stride-p patch conv (flax's SAME padding), a learned ``pos_embed`` of shape
(1, gh, gw, dim), then blocks of windowed attention (zero padding after
``norm1``, padded keys unmasked) with a few global blocks. Where it differs
from detectron2's ViT, it follows the JAX module: no relative position term,
LayerNorm eps 1e-6, exact-erf GELU, and ``pos_embed`` made for one grid: the
grid of the input the model was built for (``build_backbone``'s
``input_hw``), and a forward at another grid raises, as the JAX module does
when applied to its parameters. Attention is plain ops, as the JAX module
writes it: scale q, ``q @ k^T``, softmax, ``@ v``.

Everything computes in f32 whatever the input's dtype (the JAX package
builds the trunk and the pyramid with no dtype: flax promotes a bf16 image to
the f32 parameters) and the maps come out f32.

Names are detectron2's: ``net.patch_embed.proj``, ``net.pos_embed``,
``net.blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``, and
the pyramid's ``simfp_{2..5}`` Sequentials (``simfp_2``: deconv, LN, GELU,
deconv, then the 1x1 and 3x3 convs each with its ``.norm``).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from u2seg_torch.models.layers import Conv2d


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> (B * windows, ws, ws, C), zero-padded at the bottom
    and right to multiples of ``ws``; also the padded (Hp, Wp)."""
    b, h, w, c = x.shape
    ph, pw = (-h) % ws, (-w) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(x: torch.Tensor, ws: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // ((hp // ws) * (wp // ws))
    x = x.view(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


def same_pad(x: torch.Tensor, k: int) -> torch.Tensor:
    """flax's SAME padding of an NCHW map for a k x k conv of stride k."""
    h, w = x.shape[2:]
    th, tw = (-h) % k, (-w) % k
    if th == tw == 0:
        return x
    return F.pad(x, (tw // 2, tw - tw // 2, th // 2, th - th // 2))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias=None) -> torch.Tensor:
    """softmax((q * d^-0.5) @ k^T (+ bias)) @ v over (..., N, d) heads."""
    attn = (q * q.shape[-1] ** -0.5) @ k.transpose(-2, -1)
    if bias is not None:
        attn = attn + bias
    return torch.softmax(attn, dim=-1) @ v


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ViTAttention(nn.Module):
    """Multi-head self-attention over a (B, H, W, C) map."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, h, w, c = x.shape
        n = h * w
        qkv = self.qkv(x.reshape(b, n, c)).view(b, n, 3, self.num_heads, -1)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        out = attention(q, k, v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out).view(b, h, w, c)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 0,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size = window_size          # 0: global attention
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = ViTAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        y = self.norm1(x)
        if self.window_size > 0:
            hw = y.shape[1:3]
            y, pad_hw = window_partition(y, self.window_size)
            y = window_unpartition(self.attn(y), self.window_size, pad_hw, hw)
        else:
            y = self.attn(y)
        x = x + y
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """ViT-B/16 trunk by default; ``grid`` is the (gh, gw) token grid that
    ``pos_embed`` is made for. Returns the stride-p map as (B, gh, gw, dim)."""

    def __init__(self, grid: Tuple[int, int], patch_size: int = 16, dim: int = 768,
                 depth: int = 12, num_heads: int = 12, window_size: int = 14,
                 global_blocks: Sequence[int] = (2, 5, 8, 11)):
        super().__init__()
        self.patch_size = patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, *grid, dim))
        self.blocks = nn.ModuleList([
            ViTBlock(dim, num_heads, 0 if i in global_blocks else window_size)
            for i in range(depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        x = self.patch_embed.proj(same_pad(x.float(), p)).permute(0, 2, 3, 1)
        if x.shape[1:3] != self.pos_embed.shape[1:3]:
            raise ValueError(
                f"ViT: a {tuple(x.shape[1:3])} token grid, but pos_embed is made for "
                f"{tuple(self.pos_embed.shape[1:3])}: build the model for this input size")
        x = x + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return x


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _deconv(cin: int, cout: int) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(cin, cout, 2, stride=2)


class ViTDet(nn.Module):
    """ViT + SimpleFeaturePyramid: {"p2".."p6"} NCHW f32 maps (channels-last
    memory) from the single stride-16 map. p2 and p3 come from 2x2 stride-2
    transposed convs (flax's, unflipped: ``weights.from_jax`` flips them),
    p5 from a 2x2 max-pool, p6 from p5 by a 1x1 stride-2 max-pool."""

    def __init__(self, vit: ViT, out_channels: int = 256,
                 scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5)):
        super().__init__()
        self.net = vit
        dim = vit.pos_embed.shape[-1]
        for scale, lvl in zip(scale_factors, range(2, 6)):
            if scale == 4.0:
                layers = [_deconv(dim, dim // 2), LayerNorm2d(dim // 2, eps=1e-6),
                          nn.GELU(), _deconv(dim // 2, dim // 4)]
                cin = dim // 4
            elif scale == 2.0:
                layers, cin = [_deconv(dim, dim // 2)], dim // 2
            elif scale == 1.0:
                layers, cin = [], dim
            elif scale == 0.5:
                layers, cin = [nn.MaxPool2d(2, 2)], dim
            else:
                raise ValueError(f"scale factor {scale} is not supported")
            layers += [
                Conv2d(cin, out_channels, 1, bias=False,
                       norm=LayerNorm2d(out_channels, eps=1e-6)),
                Conv2d(out_channels, out_channels, 3, padding=1, bias=False,
                       norm=LayerNorm2d(out_channels, eps=1e-6)),
            ]
            self.add_module(f"simfp_{lvl}", nn.Sequential(*layers))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feat = self.net(x).permute(0, 3, 1, 2)
        out = {f"p{lvl}": getattr(self, f"simfp_{lvl}")(feat) for lvl in range(2, 6)}
        out["p6"] = out["p5"][:, :, ::2, ::2]
        return out

