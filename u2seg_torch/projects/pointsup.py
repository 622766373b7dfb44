"""PointSup: point-supervised instance segmentation (counterpart of
``u2seg_tpu/projects/pointsup.py``; detectron2's ``projects/PointSup``).

Each GT instance carries P annotated points (image coordinates and 0/1
labels); the mask head is trained with BCE at those points only. Points
outside the proposal box and padded points are ignored (label -1), and the
loss is normalised by the live points.

Mask logits are NCHW per ROI, ``(R, K, M, M)``; points ``(R, P, 2)`` as (x,
y). Which annotated points ``sample_point_annotations`` keeps is drawn from
a ``torch.Generator`` (the JAX package draws from its own key), or from the
``noise`` a caller gives.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from u2seg_torch.ops.nms import topk_stable
from u2seg_torch.projects.pointrend import point_sample


def get_point_coords_wrt_box(boxes: torch.Tensor, point_coords: torch.Tensor) -> torch.Tensor:
    """Image coordinates (R, P, 2) -> box-normalised [0, 1]^2 coordinates of
    the XYXY ``boxes`` (R, 4). Degenerate boxes give coordinates outside
    [0, 1], which the ignore rule drops."""
    w = torch.clamp(boxes[:, None, 2] - boxes[:, None, 0], min=1e-6)
    h = torch.clamp(boxes[:, None, 3] - boxes[:, None, 1], min=1e-6)
    x = (point_coords[..., 0] - boxes[:, None, 0]) / w
    y = (point_coords[..., 1] - boxes[:, None, 1]) / h
    return torch.stack([x, y], dim=-1)


def prepare_point_targets(proposal_boxes: torch.Tensor, gt_point_coords: torch.Tensor,
                          gt_point_labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Box-normalised coordinates and f32 labels, a point outside its
    proposal labelled -1 (ignored)."""
    coords = get_point_coords_wrt_box(proposal_boxes, gt_point_coords)
    outside = ((coords[..., 0] < 0.0) | (coords[..., 0] > 1.0)
               | (coords[..., 1] < 0.0) | (coords[..., 1] > 1.0))
    labels = torch.where(outside, torch.full_like(coords[..., 0], -1.0),
                         gt_point_labels.float())
    return coords, labels


def sample_point_annotations(point_coords: torch.Tensor, point_labels: torch.Tensor,
                             num_sample: int, generator: Optional[torch.Generator] = None,
                             noise: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep ``num_sample`` of each instance's P points, drawn without
    replacement (the top ``num_sample`` of uniform ``noise`` (R, P)); all
    points when ``num_sample`` <= 0 or >= P. -> (R, num_sample, 2), (R,
    num_sample)."""
    r, p, _ = point_coords.shape
    if num_sample <= 0 or num_sample >= p:
        return point_coords, point_labels
    if noise is None:
        noise = torch.rand((r, p), generator=generator, device=point_coords.device)
    _, idx = topk_stable(noise, num_sample)
    coords = torch.gather(point_coords, 1, idx[..., None].expand(-1, -1, 2))
    return coords, torch.gather(point_labels, 1, idx)


def annotations_to_point_arrays(annos, capacity: int, points_per_instance: int):
    """COCO-with-points annotation dicts (``point_coords``,
    ``point_labels``) -> fixed-capacity numpy arrays: instances padded to
    ``capacity`` rows, points to ``points_per_instance``; padded points
    carry label -1 (ignored)."""
    coords = np.zeros((capacity, points_per_instance, 2), np.float32)
    labels = np.full((capacity, points_per_instance), -1.0, np.float32)
    for i, ann in enumerate(annos[:capacity]):
        pc = np.asarray(ann.get("point_coords", []), np.float32).reshape(-1, 2)
        pl = np.asarray(ann.get("point_labels", []), np.float32).reshape(-1)
        n = min(len(pl), points_per_instance)
        coords[i, :n] = pc[:n]
        labels[i, :n] = pl[:n]
    return coords, labels


def point_sup_mask_loss(
    mask_logits: torch.Tensor,    # (R, K, M, M) per-class mask logits
    gt_classes: torch.Tensor,     # (R,) int
    point_coords: torch.Tensor,   # (R, P, 2) box-normalised (x, y)
    point_labels: torch.Tensor,   # (R, P) {0, 1}, < 0 ignored
    valid: torch.Tensor,          # (R,) foreground and not padding
) -> torch.Tensor:
    """BCE of the GT class's mask logit sampled at each annotated point,
    averaged over the live points of valid instances."""
    k = mask_logits.shape[1]
    cls = torch.clamp(gt_classes.long(), 0, k - 1)
    per_cls = mask_logits[torch.arange(mask_logits.shape[0], device=cls.device), cls]
    logits = point_sample(per_cls.float()[:, None], point_coords)[..., 0]     # (R, P)
    live = (point_labels >= 0) & valid[:, None]
    tgt = torch.clamp(point_labels, 0.0, 1.0)
    per_point = (torch.clamp(logits, min=0) - logits * tgt
                 + torch.log1p(torch.exp(-torch.abs(logits))))
    denom = torch.clamp(live.sum().float(), min=1.0)
    return torch.sum(per_point * live) / denom
