"""Keypoint R-CNN head (counterpart of ``u2seg_tpu/models/keypoint_head.py``).

``KRCNNConvDeconvUpsampleHead``: ``conv_fcn{1..8}`` 3x3 convs + relu, the
``score_lowres`` 4x4 stride-2 transposed conv (padding 1, detectron2's), then
an exact 2x bilinear upsample; (N, S, S, C) pooled features in, (N, 4S, 4S,
K) f32 heatmap logits out. The loss is the softmax cross-entropy over the
heatmap bins at each visible keypoint; inference decodes each heatmap's
argmax.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from u2seg_torch.models.layers import Conv2d, ConvTranspose2d
from u2seg_torch.models.sem_seg import upsample_bilinear
from u2seg_torch.ops.losses import softmax_ce
from u2seg_torch.structures.keypoints import (heatmaps_to_keypoints,
                                              keypoints_to_heatmap)


class KRCNNConvDeconvUpsampleHead(nn.Module):
    def __init__(self, in_channels: int, num_keypoints: int = 17,
                 conv_dims: Sequence[int] = (512,) * 8):
        super().__init__()
        self.num_conv = len(conv_dims)
        ch = in_channels
        for i, d in enumerate(conv_dims):
            self.add_module(f"conv_fcn{i + 1}", Conv2d(ch, d, 3, padding=1))
            ch = d
        self.score_lowres = ConvTranspose2d(ch, num_keypoints, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"conv_fcn{i + 1}")(x))
        x = upsample_bilinear(self.score_lowres(x), 2)
        return x.permute(0, 2, 3, 1).float()


def keypoint_rcnn_loss(heatmap_logits: torch.Tensor, gt_keypoints: torch.Tensor,
                       rois: torch.Tensor, valid_roi: torch.Tensor,
                       normalizer: Optional[float] = None) -> torch.Tensor:
    """Cross-entropy over the S * S bins at visible keypoints: logits (N, S,
    S, K), keypoints (N, K, 3), rois (N, 4), valid_roi (N,). Divided by
    ``normalizer``, or by the number of keypoints that count."""
    n, s, _, k = heatmap_logits.shape
    targets, vis = keypoints_to_heatmap(gt_keypoints, rois, s)
    logits = heatmap_logits.permute(0, 3, 1, 2).reshape(n, k, s * s)
    mask = vis & valid_roi[:, None]
    total = (softmax_ce(logits, targets) * mask).sum()
    denom = normalizer if normalizer is not None else torch.clamp(mask.sum(), min=1.0)
    return total / denom


def keypoint_rcnn_inference(heatmap_logits: torch.Tensor,
                            rois: torch.Tensor) -> torch.Tensor:
    """(N, K, 4): x, y, logit, prob of each keypoint."""
    return heatmaps_to_keypoints(heatmap_logits, rois)
