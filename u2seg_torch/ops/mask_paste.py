"""Mask pasting as separable matmuls (counterpart of
``u2seg_tpu/ops/mask_paste.py``).

Pasting one M x M mask into an H x W canvas with zero-padded bilinear
resampling (grid_sample, align_corners=False) is ``W_y (H,M) @ mask (M,M)
@ W_x^T (M,W)`` for an axis-aligned box.
"""
from __future__ import annotations

import torch


def _axis_weights(lo: torch.Tensor, hi: torch.Tensor, out_size: int,
                  m: int) -> torch.Tensor:
    """(K, out_size, m) f32: weight of source cell j for output pixel p is
    relu(1 - |(p + 0.5 - lo) / (hi - lo) * m - 0.5 - j|)."""
    p = torch.arange(out_size, dtype=torch.float32, device=lo.device) + 0.5
    size = torch.clamp(hi - lo, min=1e-4)
    coord = (p[None, :] - lo[:, None]) / size[:, None] * m - 0.5
    j = torch.arange(m, dtype=torch.float32, device=lo.device)
    return torch.clamp(1.0 - torch.abs(coord[:, :, None] - j[None, None, :]),
                       min=0.0)


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, out_h: int,
                out_w: int) -> torch.Tensor:
    """masks (K, M, M), boxes (K, 4) XYXY in canvas coordinates ->
    (K, out_h, out_w) f32, zero outside each box. f32 throughout (the card's
    f32 matmul does not use TF32 unless asked)."""
    m = masks.shape[-1]
    wy = _axis_weights(boxes[:, 1], boxes[:, 3], out_h, m)     # (K, H, M)
    wx = _axis_weights(boxes[:, 0], boxes[:, 2], out_w, m)     # (K, W, M)
    tmp = torch.bmm(wy, masks.to(torch.float32))               # (K, H, M)
    return torch.bmm(tmp, wx.transpose(1, 2))                  # (K, H, W)


def paste_masks_scaled(masks: torch.Tensor, boxes: torch.Tensor, out_h: int,
                       out_w: int, stride: int) -> torch.Tensor:
    """Paste into a coarser canvas (e.g. stride 4 for the panoptic fusion):
    ``boxes`` in input-image coordinates, the canvas (out_h, out_w) at
    ``stride`` pixels per cell."""
    return paste_masks(masks, boxes / float(stride), out_h, out_w)
