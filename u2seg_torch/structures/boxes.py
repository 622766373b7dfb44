"""Box utilities as plain functions on tensors.

Counterpart of ``u2seg_tpu/structures/boxes.py``: boxes are ``(..., 4)``
float tensors in XYXY absolute coordinates. The float op order of every
function follows the JAX package, so the same f32 inputs give the same
f32 outputs up to the libraries' own rounding.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

#: clamp on dw/dh — log(max box scale change)
SCALE_CLAMP = math.log(1000.0 / 16)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of XYXY boxes; negative extents clamp to 0. Shape (...,)."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def clip(boxes: torch.Tensor, image_hw) -> torch.Tensor:
    """Clip XYXY boxes to [0, W] x [0, H]. ``image_hw``'s last axis is
    (H, W); its leading axes broadcast against the boxes' leading axes (one
    size per row of boxes)."""
    hw = torch.as_tensor(image_hw, device=boxes.device).to(boxes.dtype)
    h, w = hw[..., 0:1], hw[..., 1:2]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x0 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y0 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x1 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x0, y0, x1, y1], dim=-1)


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Bool mask of boxes with both sides > threshold."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w > threshold) & (h > threshold)


def pairwise_intersection(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Intersection areas, shape (..., N, M)."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU matrix, shape (..., N, M). Zero where the union is empty."""
    inter = pairwise_intersection(boxes1, boxes2)
    a1 = area(boxes1)[..., :, None]
    a2 = area(boxes2)[..., None, :]
    union = a1 + a2 - inter
    iou = inter / torch.clamp(union, min=1e-12)
    return torch.where(union > 0, iou, torch.zeros_like(iou))


def get_deltas(
    src_boxes: torch.Tensor,
    target_boxes: torch.Tensor,
    weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Encode target boxes relative to source boxes as (dx, dy, dw, dh).
    Degenerate sides are floored at 1e-6; callers mask invalid rows."""
    src_w = torch.clamp(src_boxes[..., 2] - src_boxes[..., 0], min=1e-6)
    src_h = torch.clamp(src_boxes[..., 3] - src_boxes[..., 1], min=1e-6)
    src_cx = src_boxes[..., 0] + 0.5 * src_w
    src_cy = src_boxes[..., 1] + 0.5 * src_h

    tgt_w = torch.clamp(target_boxes[..., 2] - target_boxes[..., 0], min=1e-6)
    tgt_h = torch.clamp(target_boxes[..., 3] - target_boxes[..., 1], min=1e-6)
    tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
    tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h

    wx, wy, ww, wh = weights
    dx = wx * (tgt_cx - src_cx) / src_w
    dy = wy * (tgt_cy - src_cy) / src_h
    dw = ww * torch.log(tgt_w / src_w)
    dh = wh * torch.log(tgt_h / src_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def apply_deltas(
    deltas: torch.Tensor,
    boxes: torch.Tensor,
    weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
    scale_clamp: float = SCALE_CLAMP,
) -> torch.Tensor:
    """Decode (dx, dy, dw, dh) deltas on boxes -> XYXY boxes.

    ``deltas`` may have shape (..., K*4) applied to boxes (..., 4): each
    group of 4 is decoded against the same box. Dtypes promote as in the
    JAX package: a bf16 delta stays bf16 through the weight division, the
    clamp and the exp, and meets the f32 box in f32.
    """
    orig_shape = deltas.shape
    k4 = orig_shape[-1]
    assert k4 % 4 == 0, "last dim of deltas must be a multiple of 4"
    d = deltas.reshape(orig_shape[:-1] + (k4 // 4, 4))

    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    wx, wy, ww, wh = weights
    dx = d[..., 0] / wx
    dy = d[..., 1] / wy
    dw = torch.clamp(d[..., 2] / ww, max=scale_clamp)
    dh = torch.clamp(d[..., 3] / wh, max=scale_clamp)

    pred_cx = dx * w[..., None] + cx[..., None]
    pred_cy = dy * h[..., None] + cy[..., None]
    pred_w = torch.exp(dw) * w[..., None]
    pred_h = torch.exp(dh) * h[..., None]

    out = torch.stack([
        pred_cx - 0.5 * pred_w,
        pred_cy - 0.5 * pred_h,
        pred_cx + 0.5 * pred_w,
        pred_cy + 0.5 * pred_h,
    ], dim=-1)
    return out.reshape(orig_shape)
