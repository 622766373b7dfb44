"""Anchor/proposal-to-GT matching on fixed-size quality matrices
(counterpart of ``u2seg_tpu/models/matcher.py``)."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def match(
    quality: torch.Tensor,
    gt_valid: torch.Tensor,
    thresholds: Sequence[float],
    labels: Sequence[int],
    allow_low_quality_matches: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match predictions to ground truth by max quality (IoU).

    quality: (..., N_gt, N_pred); gt_valid: (..., N_gt) bool. ``labels`` has
    len(thresholds)+1 values in {-1, 0, 1} for the intervals (-inf, t0),
    [t0, t1), ..., [tk, inf). With ``allow_low_quality_matches`` every
    prediction that reaches a valid gt's max quality becomes positive, ties
    included, even when that max is 0 (a gt overlapping nothing marks all
    predictions positive, as detectron2 does).

    Returns matched_idx (..., N_pred) int64 (0 with no valid gt; the first
    index of the maximum, as ``jnp.argmax``) and match_labels int8.
    """
    assert len(labels) == len(thresholds) + 1
    q = torch.where(gt_valid[..., :, None], quality,
                    torch.full_like(quality, -1.0))     # invalid gt never wins
    matched_vals = q.amax(dim=-2)
    matched_idx = q.argmax(dim=-2)     # the first index of the maximum
    any_valid = gt_valid.any(dim=-1, keepdim=True)

    match_labels = torch.full(matched_vals.shape, labels[0], dtype=torch.int8,
                              device=q.device)
    for lab, lo in zip(labels[1:], thresholds):
        match_labels = torch.where(matched_vals >= lo, lab, match_labels)

    if allow_low_quality_matches:
        per_gt_max = q.amax(dim=-1, keepdim=True)
        is_best = (q >= per_gt_max) & gt_valid[..., :, None]
        match_labels = torch.where(is_best.any(dim=-2), 1, match_labels)

    match_labels = torch.where(any_valid, match_labels, labels[0]).to(torch.int8)
    matched_idx = torch.where(any_valid, matched_idx, 0)
    return matched_idx, match_labels
