"""ASPP (atrous spatial pyramid pooling) and depthwise-separable conv blocks
(counterpart of ``u2seg_tpu/ops/aspp.py``; detectron2's ``layers/aspp.py``
and ``layers/blocks.py``), used by the DeepLab project heads.

NCHW. Module names are the JAX package's (``b0`` ... ``b3``, ``pool_conv``,
``project``; ``depthwise``, ``pointwise``); the norms sit in ``norms`` in
the order flax numbers them. ``resize_bilinear`` is ``jax.image.resize(...,
"bilinear")``: half-pixel bilinear, antialiased when it shrinks, a
broadcast from 1 x 1.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from u2seg_torch.models.layers import Conv2d
from u2seg_torch.ops.norms import get_norm


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, h, w) as ``jax.image.resize`` bilinear resizes
    (the weights of ``pseudo.dino._resize_weights``, per axis)."""
    from u2seg_torch.pseudo.dino import _resize_weights

    h, w = size
    if x.shape[2:] == (1, 1):
        return x.expand(x.shape[0], x.shape[1], h, w)
    if x.shape[2] != h:
        x = torch.einsum("bchw,ho->bcow", x, _resize_weights(x.shape[2], h).to(x))
    if x.shape[3] != w:
        x = torch.einsum("bchw,wo->bcho", x, _resize_weights(x.shape[3], w).to(x))
    return x


def _norms(norm: str, features: Sequence[int]) -> nn.ModuleList:
    return nn.ModuleList([get_norm(norm, f) for f in features] if norm else [])


def _apply(norms: nn.ModuleList, i: int, x: torch.Tensor) -> torch.Tensor:
    return norms[i](x) if len(norms) else x


class DepthwiseSeparableConv(nn.Module):
    """depthwise k x k + pointwise 1x1, each followed by norm and relu."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 padding: int = 1, dilation: int = 1, norm: str = "GN"):
        super().__init__()
        self.depthwise = Conv2d(in_channels, in_channels, kernel_size, padding=padding,
                                dilation=dilation, groups=in_channels, bias=not norm)
        self.pointwise = Conv2d(in_channels, features, 1, bias=not norm)
        self.norms = _norms(norm, (in_channels, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(_apply(self.norms, 0, self.depthwise(x)))
        return F.relu(_apply(self.norms, 1, self.pointwise(x)))


class ASPP(nn.Module):
    """A 1x1 branch, three dilated 3x3 branches and image pooling (global,
    or ``pool_kernel_size`` average pooling), fused by a 1x1 projection."""

    def __init__(self, in_channels: int, features: int,
                 dilations: Tuple[int, int, int] = (6, 12, 18), norm: str = "GN",
                 dropout: float = 0.0, pool_kernel_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.dropout = dropout
        self.pool_kernel_size = pool_kernel_size
        self.b0 = Conv2d(in_channels, features, 1, bias=not norm)
        for i, d in enumerate(dilations):
            self.add_module(f"b{i + 1}", Conv2d(in_channels, features, 3, padding=d,
                                                dilation=d, bias=not norm))
        self.pool_conv = Conv2d(in_channels, features, 1)
        self.project = Conv2d(features * (len(dilations) + 2), features, 1, bias=not norm)
        self.norms = _norms(norm, (features,) * (len(dilations) + 2))
        self.num_dilated = len(dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [F.relu(_apply(self.norms, 0, self.b0(x)))]
        for i in range(self.num_dilated):
            b = getattr(self, f"b{i + 1}")(x)
            branches.append(F.relu(_apply(self.norms, i + 1, b)))
        if self.pool_kernel_size is None:
            pooled = x.mean(dim=(2, 3), keepdim=True)
        else:
            pooled = F.avg_pool2d(x, self.pool_kernel_size, self.pool_kernel_size)
        pooled = F.relu(self.pool_conv(pooled))
        branches.append(resize_bilinear(pooled, x.shape[2:]))
        out = self.project(torch.cat(branches, dim=1))
        out = F.relu(_apply(self.norms, self.num_dilated + 1, out))
        if self.dropout > 0 and self.training:
            out = F.dropout(out, self.dropout, training=True)
        return out
