"""Keypoint heatmap targets and decoding (counterpart of
``u2seg_tpu/structures/keypoints.py``).

Keypoints travel as ``(N, K, 3)`` tensors of (x, y, visibility). Targets are
flat bin indices of a ``heatmap_size``-square grid over each ROI; a keypoint
on the ROI's right or bottom edge (within 1e-4) goes to the last bin, as in
detectron2. Decoding takes each heatmap's argmax at heatmap resolution and
adds a half-bin offset: the JAX package leaves out detectron2's refinement on
an upsampled map, and so does the port.
"""
from __future__ import annotations

from typing import Tuple

import torch


def keypoints_to_heatmap(keypoints: torch.Tensor, rois: torch.Tensor,
                         heatmap_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """keypoints (N, K, 3), rois (N, 4) XYXY -> (flat bin index (N, K) int64,
    valid (N, K) bool: visible and inside the grid)."""
    x0, y0 = rois[:, 0:1], rois[:, 1:2]
    w, h = (rois[:, 2] - rois[:, 0])[:, None], (rois[:, 3] - rois[:, 1])[:, None]
    scale_x = heatmap_size / torch.clamp(w, min=1e-6)
    scale_y = heatmap_size / torch.clamp(h, min=1e-6)
    x, y = keypoints[..., 0], keypoints[..., 1]
    x_edge = (x - (x0 + w)).abs() < 1e-4
    y_edge = (y - (y0 + h)).abs() < 1e-4

    def bins(v):
        # every value outside [0, heatmap_size) is invalid: clamping before
        # the integer cast keeps far-away (or padding) points from overflowing
        return torch.clamp(torch.floor(v), -1, heatmap_size).long()

    xi = torch.where(x_edge, heatmap_size - 1, bins((x - x0) * scale_x))
    yi = torch.where(y_edge, heatmap_size - 1, bins((y - y0) * scale_y))
    inside = (xi >= 0) & (yi >= 0) & (xi < heatmap_size) & (yi < heatmap_size)
    valid = inside & (keypoints[..., 2] > 0)
    lin = (torch.clamp(yi, 0, heatmap_size - 1) * heatmap_size
           + torch.clamp(xi, 0, heatmap_size - 1))
    return lin, valid


def heatmaps_to_keypoints(maps: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
    """maps (N, S, S, K) logits, rois (N, 4) -> (N, K, 4): x, y, the argmax
    logit and its softmax probability over the S * S bins."""
    n, hs, _, k = maps.shape
    width_corr = torch.clamp(rois[:, 2] - rois[:, 0], min=1e-6) / hs
    height_corr = torch.clamp(rois[:, 3] - rois[:, 1], min=1e-6) / hs
    flat = maps.permute(0, 3, 1, 2).reshape(n, k, hs * hs)
    pos = flat.argmax(dim=-1)               # the first index of the maximum
    logits = flat.amax(dim=-1)
    probs = torch.softmax(flat, dim=-1).amax(dim=-1)
    yi = torch.div(pos, hs, rounding_mode="floor").float()
    xi = (pos % hs).float()
    x = (xi + 0.5) * width_corr[:, None] + rois[:, 0:1]
    y = (yi + 0.5) * height_corr[:, None] + rois[:, 1:2]
    return torch.stack([x, y, logits, probs], dim=-1)
