"""Loss functions (counterpart of ``u2seg_tpu/ops/losses.py``).

All losses return per-element values; callers apply masks and normalise.
The cross-entropies compute in f32 whatever the input dtype.
"""
from __future__ import annotations

import math

import torch


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    """Huber / smooth-L1; beta = 0 is pure L1."""
    diff = torch.abs(pred - target)
    if beta <= 1e-8:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def _box_wh(b):
    return (torch.clamp(b[..., 2] - b[..., 0], min=0.0),
            torch.clamp(b[..., 3] - b[..., 1], min=0.0))


def _pairwise_aligned(boxes1, boxes2):
    x1 = torch.maximum(boxes1[..., 0], boxes2[..., 0])
    y1 = torch.maximum(boxes1[..., 1], boxes2[..., 1])
    x2 = torch.minimum(boxes1[..., 2], boxes2[..., 2])
    y2 = torch.minimum(boxes1[..., 3], boxes2[..., 3])
    inter = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    w1, h1 = _box_wh(boxes1)
    w2, h2 = _box_wh(boxes2)
    union = w1 * h1 + w2 * h2 - inter
    iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-7),
                      torch.zeros_like(union))
    return iou, union


def _enclosing(boxes1, boxes2):
    ex1 = torch.minimum(boxes1[..., 0], boxes2[..., 0])
    ey1 = torch.minimum(boxes1[..., 1], boxes2[..., 1])
    ex2 = torch.maximum(boxes1[..., 2], boxes2[..., 2])
    ey2 = torch.maximum(boxes1[..., 3], boxes2[..., 3])
    return ex1, ey1, ex2, ey2


def giou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Generalized IoU loss on aligned boxes."""
    iou, union = _pairwise_aligned(boxes1, boxes2)
    ex1, ey1, ex2, ey2 = _enclosing(boxes1, boxes2)
    enclose = torch.clamp(ex2 - ex1, min=0.0) * torch.clamp(ey2 - ey1, min=0.0)
    giou = iou - torch.where(
        enclose > 0, (enclose - union) / torch.clamp(enclose, min=1e-7),
        torch.zeros_like(enclose))
    return 1.0 - giou


def diou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Distance-IoU loss."""
    iou, _ = _pairwise_aligned(boxes1, boxes2)
    cx1 = (boxes1[..., 0] + boxes1[..., 2]) * 0.5
    cy1 = (boxes1[..., 1] + boxes1[..., 3]) * 0.5
    cx2 = (boxes2[..., 0] + boxes2[..., 2]) * 0.5
    cy2 = (boxes2[..., 1] + boxes2[..., 3]) * 0.5
    center_dist = (cx1 - cx2) ** 2 + (cy1 - cy2) ** 2
    ex1, ey1, ex2, ey2 = _enclosing(boxes1, boxes2)
    diag = (ex2 - ex1) ** 2 + (ey2 - ey1) ** 2
    return 1.0 - iou + center_dist / torch.clamp(diag, min=1e-7)


def ciou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Complete-IoU loss; the trade-off weight carries no gradient."""
    iou, _ = _pairwise_aligned(boxes1, boxes2)
    d = diou_loss(boxes1, boxes2)
    w1, h1 = _box_wh(boxes1)
    w2, h2 = _box_wh(boxes2)
    v = (4.0 / math.pi ** 2) * (
        torch.atan(w2 / torch.clamp(h2, min=1e-7))
        - torch.atan(w1 / torch.clamp(h1, min=1e-7))) ** 2
    alpha = (v / torch.clamp(1.0 - iou + v, min=1e-7)).detach()
    return d + alpha * v


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Per-element focal loss."""
    p = torch.sigmoid(logits)
    ce = bce_with_logits(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        a_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
        loss = a_t * loss
    return loss


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``, with no
    threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross-entropy on logits, per element, f32."""
    logits = logits.float()
    targets = targets.float()
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element softmax cross-entropy with integer labels over the last
    axis, f32. Out-of-range labels (padding) are clamped; callers mask."""
    logits = logits.float()
    num = logits.shape[-1]
    safe = torch.clamp(labels.long(), 0, num - 1)
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    return logz - picked


def softmax_ce_ignore(logits: torch.Tensor, labels: torch.Tensor,
                      ignore_label: int = 255) -> torch.Tensor:
    """Mean softmax CE over elements whose label != ignore_label (the
    sem-seg loss)."""
    valid = labels != ignore_label
    per = softmax_ce(logits, torch.where(valid, labels, torch.zeros_like(labels)))
    denom = torch.clamp(valid.sum(), min=1)
    return (per * valid).sum() / denom
