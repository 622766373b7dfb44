"""Normalization layers.

Counterpart of ``u2seg_tpu/ops/norms.py``:

- ``BatchNorm2d`` (BN, SyncBN, FrozenBN). In eval mode, and always when
  frozen, the running statistics are folded into one per-channel affine in
  f32 (``mul = rsqrt(var + eps) * weight``, ``add = -mean * mul + bias``)
  applied in the activation dtype. In training mode (``.train()``; a new
  layer starts in eval mode) it is flax's BatchNorm:
  batch moments over (B, H, W) in f32 with the fast variance
  ``max(0, E[x^2] - E[x]^2)``, ``(x - mean) * (rsqrt(var + eps) * weight) +
  bias`` in f32 cast to the activation dtype, and running statistics moved
  by ``new = 0.9 * old + 0.1 * batch`` with the BIASED batch variance
  (``torch.nn.BatchNorm2d`` stores the unbiased one and counts momentum the
  other way round). Gradients flow through the batch moments. SyncBN
  (``sync=True``) averages ``[E[x], E[x^2]]`` over the default process group
  before the variance, with a differentiable all-reduce (its backward sums
  the moments' gradients over the processes), as flax's BatchNorm with
  ``axis_name="data"`` does with ``pmean``; with no group, or a group of
  one, it is BN. Parameter and buffer names are detectron2's (``weight``,
  ``bias``, ``running_mean``, ``running_var``), so a d2 state dict loads as
  it is.
- ``BNBatchStats`` / ``SyncBNBatchStats``: ``projects.rethinking_bn.
  BatchNormBatchStats`` (batch moments at eval too).
- ``GroupNorm``: flax's formula: f32 statistics with the fast variance
  ``E[x^2] - E[x]^2`` clipped at 0, ``(x - mean) * (rsqrt(var + eps) *
  weight) + bias``, result cast to the activation dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from u2seg_torch.parallel import comm


class BatchNorm2d(nn.Module):
    """BatchNorm on NCHW tensors (see the module doc). ``frozen`` is
    FrozenBN: never batch statistics, no gradient to weight and bias.
    ``sync`` is SyncBN: batch moments averaged over the process group."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9, frozen: bool = False,
                 sync: bool = False):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.frozen = frozen
        self.sync = sync
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        # like the JAX package's norm, which uses the running statistics
        # unless a caller asks for training: a new layer starts in eval mode
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        if self.training and not self.frozen:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            mean2 = (xf * xf).mean(dim=(0, 2, 3))
            world = comm.get_world_size() if self.sync else 1
            if world > 1:
                from torch.distributed.nn.functional import all_reduce

                mean, mean2 = (all_reduce(torch.stack([mean, mean2])) / world).unbind(0)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
            mul = torch.rsqrt(var + self.eps) * self.weight
            y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
            return y.to(x.dtype)
        weight, bias = self.weight, self.bias
        if self.frozen:
            weight, bias = weight.detach(), bias.detach()
        mul = torch.rsqrt(self.running_var + self.eps) * weight
        add = -self.running_mean * mul + bias
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
    """Norm factory mirroring the JAX package's ``get_norm``."""
    if not norm:
        return None
    if norm in ("BN", "SyncBN", "naiveSyncBN", "FrozenBN"):
        return BatchNorm2d(features, eps=1e-5, momentum=0.9,
                           frozen=norm == "FrozenBN",
                           sync=norm in ("SyncBN", "naiveSyncBN"))
    if norm in ("BNBatchStats", "SyncBNBatchStats"):
        from u2seg_torch.projects.rethinking_bn import BatchNormBatchStats

        return BatchNormBatchStats(features, eps=1e-5, momentum=0.9,
                                   sync=norm.startswith("Sync"))
    if norm == "GN":
        groups = 32 if features % 32 == 0 else math.gcd(32, features)
        return GroupNorm(max(groups, 1), features, eps=1e-5)
    raise ValueError(f"Unknown norm: {norm}")
