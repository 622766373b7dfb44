"""DINO Vision Transformer feature extractor (counterpart of
``u2seg_tpu/pseudo/dino.py``).

``DinoViT`` carries the official DINO parameter names (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,
mlp.fc1,mlp.fc2}``, ``norm``), so a DINO ``.pth`` loads as it is through
``load_dino_state_dict``. It takes NCHW normalised crops and returns the cls
feature and the per-patch key/query/value facet (or the normed output) of
the last block, in f32 as the JAX module computes them.

The position embedding is resized once, when a state dict is loaded
(``interpolate_pos_embed``: ``jax.image.resize(..., "bilinear")`` with its
default antialiasing, reproduced here), as the JAX package does; DINO itself
interpolates bicubically at every forward.
"""
from __future__ import annotations

import logging
import math
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

logger = logging.getLogger(__name__)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))          # exact GELU


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        """Returns the projected output and (q, k, v), each (b, heads, n, d)."""
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.softmax((q @ k.transpose(-2, -1)) * (c // h) ** -0.5, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out), (q, k, v)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MLP(dim, int(dim * mlp_ratio))

    def forward(self, x):
        y, qkv = self.attn(self.norm1(x))
        x = x + y
        return x + self.mlp(self.norm2(x)), qkv


class DinoViT(nn.Module):
    """DINO ViT backbone; ``forward`` returns (cls (B, D), patch facet
    features (B, n, D)) of the last block. ``img_size`` sets the grid of
    ``pos_embed`` (square crops of that side)."""

    def __init__(self, patch_size: int = 16, dim: int = 768, depth: int = 12,
                 num_heads: int = 12, facet: str = "k", img_size: int = 224):
        super().__init__()
        if facet not in ("q", "k", "v", "out"):
            raise ValueError(f"facet must be q, k, v or out, not {facet!r}")
        self.patch_size, self.dim, self.facet = patch_size, dim, facet
        grid = img_size // patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, dim))
        self.blocks = nn.ModuleList(Block(dim, num_heads) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images: (B, 3, H, W) normalised."""
        b = images.shape[0]
        x = self.patch_embed.proj(images).flatten(2).transpose(1, 2)   # (B, n, D)
        if x.shape[1] + 1 != self.pos_embed.shape[1]:
            raise ValueError(f"{x.shape[1]} patches, but pos_embed holds "
                             f"{self.pos_embed.shape[1] - 1}")
        x = torch.cat([self.cls_token.expand(b, 1, self.dim), x], 1) + self.pos_embed
        for blk in self.blocks:
            x, qkv = blk(x)
        x = self.norm(x)
        if self.facet == "out":
            patch = x[:, 1:, :]
        else:
            f = qkv["qkv".index(self.facet)]                           # (b, h, n, d)
            patch = f.transpose(1, 2).reshape(b, -1, self.dim)[:, 1:, :]
        return x[:, 0, :], patch


def seeded_dino_state(model: DinoViT, seed: int = 0) -> DinoViT:
    """Draw DINO's initialisation from a CPU generator seeded with ``seed``:
    normal with std 0.02 for the linear weights, the position embedding and
    the cls token (DINO's ``trunc_normal_`` cuts at +-2, 100 std away),
    biases zero, norms identity, the patch projection as torch's default.
    Returns ``model``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".norm" in name or name.startswith("norm"):
                p.fill_(1.0)
            elif name == "patch_embed.proj.weight":
                bound = 1.0 / math.sqrt(p[0].numel())
                p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * bound)
            else:
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    return model


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize``'s bilinear (triangle)
    kernel with antialiasing, in f32 as ``compute_weight_mat`` makes them:
    widened by the inverse scale when shrinking, columns normalised, and a
    sample outside the input zeroed."""
    inv = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    kernel_scale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = torch.clamp(1 - x.abs(), min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate_pos_embed(pos, gh: int, gw: int) -> torch.Tensor:
    """Resize a (1, 1 + g0*g0, D) position embedding to a gh x gw grid, as
    ``jax.image.resize(grid, (1, gh, gw, D), "bilinear")`` does (antialiased
    when shrinking; an axis of equal size is left as it is). CPU f32."""
    pos = torch.as_tensor(np.asarray(pos, np.float32) if not isinstance(pos, torch.Tensor)
                          else pos.detach().float().cpu())
    g0 = int(math.sqrt(pos.shape[1] - 1))
    grid = pos[0, 1:].reshape(g0, g0, -1)
    if gh != g0:
        grid = torch.einsum("hwd,ho->owd", grid, _resize_weights(g0, gh))
    if gw != g0:
        grid = torch.einsum("hwd,wo->hod", grid, _resize_weights(g0, gw))
    return torch.cat([pos[:, :1], grid.reshape(1, gh * gw, -1)], dim=1)


def load_dino_state_dict(model: DinoViT, state: Mapping,
                         grid_hw: Optional[Tuple[int, int]] = None) -> DinoViT:
    """Copy a DINO state dict in the official names (tensors or arrays) into
    ``model``, resizing ``pos_embed`` to ``grid_hw`` when it is given (the
    port's side of the JAX package's ``convert_dino_vit``). Raises on a name
    the model needs that the file lacks; names the model has no use for (a
    projection head) are logged and skipped."""
    own = model.state_dict()
    sd = {}
    for k, v in state.items():
        if k in own:
            sd[k] = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
    if grid_hw is not None:
        sd["pos_embed"] = interpolate_pos_embed(sd["pos_embed"], *grid_hw)
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"DINO state dict lacks {missing}")
    skipped = sorted(set(state) - set(sd))
    if skipped:
        logger.info("load_dino_state_dict: skipped %d names the model has no use "
                    "for (%s ...)", len(skipped), skipped[0])
    model.load_state_dict(sd)
    return model


def masked_crop_features(model: DinoViT, crops: torch.Tensor) -> torch.Tensor:
    """Embed masked-instance crops (B, 3, H, W), masked and normalised: the
    mean of the patch facet features per crop (ViTFeat usage in
    usl-imagenet.py:43-110)."""
    _, patch = model(crops)
    return patch.mean(dim=1)
