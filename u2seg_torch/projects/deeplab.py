"""DeepLabV3 / V3+ semantic segmentation heads and DeepLab's hard pixel
mining loss (counterpart of ``u2seg_tpu/projects/deeplab.py``; detectron2's
``projects/DeepLab``).

NCHW features in, full-resolution NCHW f32 logits out. The logits are
resized as ``jax.image.resize`` resizes them (``ops.aspp.resize_bilinear``);
without targets to the feature size times the head's output stride (32 for
V3 on res5, 4 for V3+ on res2). The loss is computed in training mode when
targets are given.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from u2seg_torch.models.layers import Conv2d
from u2seg_torch.ops.aspp import ASPP, DepthwiseSeparableConv, resize_bilinear
from u2seg_torch.ops.losses import softmax_ce


def hard_pixel_mining_loss(logits: torch.Tensor, targets: torch.Tensor,
                           top_k_percent: float = 0.2,
                           ignore_label: int = 255) -> torch.Tensor:
    """DeepLab's top-k CE: the mean of each image's hardest ``top_k_percent``
    pixel losses. logits (B, C, H, W), targets (B, H, W) with
    ``ignore_label`` pixels at loss 0."""
    valid = targets != ignore_label
    per = softmax_ce(logits.permute(0, 2, 3, 1),
                     torch.where(valid, targets, torch.zeros_like(targets)))
    per = torch.where(valid, per, torch.zeros_like(per))
    flat = per.reshape(per.shape[0], -1)
    k = max(int(flat.shape[1] * top_k_percent), 1)
    return torch.topk(flat, k, dim=1).values.mean()


def _full(logits, targets, stride: int):
    if targets is not None:
        size = (targets.shape[1], targets.shape[2])
    else:
        size = (logits.shape[2] * stride, logits.shape[3] * stride)
    return resize_bilinear(logits, size)


class DeepLabV3Head(nn.Module):
    """ASPP and a 1x1 predictor over one feature (res5)."""

    def __init__(self, in_channels: int, num_classes: int, in_feature: str = "res5",
                 aspp_dim: int = 256, norm: str = "GN", common_stride: int = 4):
        super().__init__()
        self.in_feature = in_feature
        self.common_stride = common_stride
        self.aspp = ASPP(in_channels, aspp_dim, norm=norm)
        self.predictor = Conv2d(aspp_dim, num_classes, 1)

    def forward(self, features: Dict[str, torch.Tensor],
                targets: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits = self.predictor(self.aspp(features[self.in_feature]))
        full = _full(logits, targets, 32)
        if self.training and targets is not None:
            return full, {"loss_sem_seg": hard_pixel_mining_loss(full, targets)}
        return full, {}


class DeepLabV3PlusHead(nn.Module):
    """ASPP on res5 and a low-level skip from res2 through two separable
    decoder convs."""

    def __init__(self, high_channels: int, low_channels: int, num_classes: int,
                 low_feature: str = "res2", high_feature: str = "res5",
                 aspp_dim: int = 256, low_dim: int = 48, decoder_dim: int = 256,
                 norm: str = "GN"):
        super().__init__()
        self.low_feature, self.high_feature = low_feature, high_feature
        self.aspp = ASPP(high_channels, aspp_dim, norm=norm)
        self.low_proj = Conv2d(low_channels, low_dim, 1)
        self.dec1 = DepthwiseSeparableConv(aspp_dim + low_dim, decoder_dim, norm=norm)
        self.dec2 = DepthwiseSeparableConv(decoder_dim, decoder_dim, norm=norm)
        self.predictor = Conv2d(decoder_dim, num_classes, 1)

    def forward(self, features: Dict[str, torch.Tensor],
                targets: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        high = self.aspp(features[self.high_feature])
        low = self.low_proj(features[self.low_feature])
        x = torch.cat([resize_bilinear(high, low.shape[2:]), low], dim=1)
        logits = self.predictor(self.dec2(self.dec1(x)))
        full = _full(logits, targets, 4)
        if self.training and targets is not None:
            return full, {"loss_sem_seg": hard_pixel_mining_loss(full, targets)}
        return full, {}
