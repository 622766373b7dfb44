"""Swin Transformer trunk (counterpart of ``u2seg_tpu/models/swin.py``).

Shifted-window attention on (B, H, W, C) token maps with a learned relative
position bias per head, patch merging between stages, a LayerNorm
(eps 1e-5) on each stage's output: {"res2".."res5"} at strides 4-32 for an
FPN. Where it differs from detectron2's Swin, it follows the JAX module: a
shifted block rolls the UNPADDED map and only then pads it for the windows
(``window_partition``), and the shift mask is built on the padded size;
detectron2 pads first. At 800x1344 the stride-4 map is 200x336 and 200 is
not a multiple of 7, so the two orders give different results there.

The trunk computes in f32 whatever its input's dtype (the JAX package builds
it with no dtype). Names are detectron2's: ``patch_embed.{proj,norm}``,
``layers.{i}.blocks.{j}.{norm1,attn.{qkv,proj,relative_position_bias_table},
norm2,mlp.fc1,mlp.fc2}``, ``layers.{i}.downsample.{norm,reduction}``,
``norm{i}`` (the stage outputs).
"""
from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from u2seg_torch.models.vit import Mlp, attention, same_pad, window_partition, window_unpartition


def _relative_position_index(ws: int) -> np.ndarray:
    """(ws^2, ws^2) index into the (2 ws - 1)^2 bias table."""
    coords = np.stack(
        np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _shift_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """(windows, ws^2, ws^2) additive mask (0 or -100) of a shifted block on
    an Hp x Wp padded map: tokens of different regions do not attend."""
    img_mask = np.zeros((hp, wp))
    cnt = 0
    for hsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hsl, wsl] = cnt
            cnt += 1
    m = img_mask.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
    m = m.reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _device_shift_mask(hp: int, wp: int, ws: int, shift: int,
                       device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_shift_mask(hp, wp, ws, shift)).to(device)


class WindowAttention(nn.Module):
    """Attention inside (windows, ws^2, C) windows, plus the relative
    position bias and an optional per-window additive mask."""

    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_relative_position_index(window_size)), persistent=False)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        nw, n, c = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).view(nw, n, 3, h, -1).permute(2, 0, 3, 1, 4).unbind(0)
        bias = self.relative_position_bias_table[self.relative_position_index.view(-1)]
        bias = bias.view(n, n, h).permute(2, 0, 1)[None]              # (1, h, N, N)
        if mask is not None:                     # windows of one image: mask rows
            bias = bias + mask[:, None]                                 # (win, h, N, N)
            q, k, v = (t.view(-1, mask.shape[0], h, n, t.shape[-1]) for t in (q, k, v))
        out = attention(q, k, v, bias).view(nw, h, n, -1)
        return self.proj(out.transpose(1, 2).reshape(nw, n, c))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, s = self.window_size, self.shift
        y = self.norm1(x)
        if s > 0:
            y = torch.roll(y, (-s, -s), dims=(1, 2))      # before the padding
        wins, pad_hw = window_partition(y, ws)
        nw = wins.shape[0]
        mask = _device_shift_mask(*pad_hw, ws, s, x.device) if s > 0 else None
        wins = self.attn(wins.reshape(nw, ws * ws, c), mask)
        y = window_unpartition(wins.view(nw, ws, ws, c), ws, pad_hw, (h, w))
        if s > 0:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated (odd sizes zero-padded), LayerNorm, a
    linear map to twice the width."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        x = nn.functional.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, window_size,
                      shift=0 if j % 2 == 0 else window_size // 2)
            for j in range(depth)])
        self.downsample = PatchMerging(dim) if downsample else None


class SwinTransformer(nn.Module):
    """Swin-T by default: depths (2, 2, 6, 2), dim 96, heads (3, 6, 12, 24).
    Returns {"res2".."res5"} NCHW f32 maps in channels-last memory;
    ``channels`` gives each level's width."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 patch_size: int = 4,
                 out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")):
        super().__init__()
        self.patch_size = patch_size
        self.out_features = tuple(out_features)
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.patch_embed.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.layers = nn.ModuleList()
        self.channels: Dict[str, int] = {}
        dim = embed_dim
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            self.layers.append(SwinStage(dim, depth, heads, window_size,
                                         downsample=i < len(depths) - 1))
            name = f"res{i + 2}"
            if name in self.out_features:
                self.add_module(f"norm{i}", nn.LayerNorm(dim, eps=1e-5))
                self.channels[name] = dim
            dim *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        p = self.patch_size
        x = self.patch_embed.proj(same_pad(x.float(), p)).permute(0, 2, 3, 1)
        x = self.patch_embed.norm(x)
        out = {}
        for i, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x)
            name = f"res{i + 2}"
            if name in self.out_features:
                out[name] = getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return out
