"""Normalization layers for inference.

Counterpart of ``u2seg_tpu/ops/norms.py`` on its inference path:

- ``BatchNorm2d`` (BN, SyncBN, FrozenBN): running statistics folded into one
  per-channel affine in f32 (``mul = rsqrt(var + eps) * weight``,
  ``add = -mean * mul + bias``), applied in the activation dtype. Parameter
  and buffer names are detectron2's (``weight``, ``bias``, ``running_mean``,
  ``running_var``), so a d2 state dict loads as it is. Cross-device moment
  sync (SyncBN) is a training concern and is not needed here.
- ``GroupNorm``: flax's formula — f32 statistics with the fast variance
  ``E[x^2] - E[x]^2`` clipped at 0, ``(x - mean) * (rsqrt(var + eps) *
  weight) + bias``, result cast to the activation dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class BatchNorm2d(nn.Module):
    """Eval-mode BatchNorm on NCHW tensors as a folded affine."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        add = -self.running_mean * mul + self.bias
        shape = (1, -1, 1, 1)
        return x * mul.to(x.dtype).view(shape) + add.to(x.dtype).view(shape)


class GroupNorm(nn.Module):
    """GroupNorm on NCHW tensors with flax's arithmetic (see module doc)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        xf = x.float()
        g = xf.reshape(b, self.num_groups, -1)
        mean = g.mean(dim=-1)
        mean2 = (g * g).mean(dim=-1)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        gs = c // self.num_groups
        mean = mean.repeat_interleave(gs, dim=1).view(b, c, 1, 1)
        var = var.repeat_interleave(gs, dim=1).view(b, c, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight.view(1, c, 1, 1)
        y = (xf - mean) * mul + self.bias.view(1, c, 1, 1)
        return y.to(x.dtype)


def get_norm(norm: Optional[str], features: int) -> Optional[nn.Module]:
    """Norm factory mirroring the JAX package's ``get_norm`` (inference)."""
    if not norm:
        return None
    if norm in ("BN", "SyncBN", "naiveSyncBN", "FrozenBN"):
        return BatchNorm2d(features, eps=1e-5)
    if norm == "GN":
        groups = 32 if features % 32 == 0 else math.gcd(32, features)
        return GroupNorm(max(groups, 1), features, eps=1e-5)
    raise ValueError(f"Unknown norm: {norm}")
