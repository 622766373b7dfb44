"""Fixed-size random fg/bg sampling for RPN anchors and ROI proposals
(counterpart of ``u2seg_tpu/models/sampling.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from portbench.refmodel.nms import topk_stable


def subsample_labels(
    labels: torch.Tensor,
    num_samples: int,
    positive_fraction: float,
    generator: Optional[torch.Generator] = None,
    pos_keys: Optional[torch.Tensor] = None,
    neg_keys: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample up to ``num_samples`` elements of ``labels`` (..., N) with at
    most ``positive_fraction`` positives (label 1); negatives (label 0) fill
    the remainder; label -1 is never sampled.

    A random subset is a top-k over uniform keys: candidates draw a key in
    [0, 1), the rest get -1. The keys come from ``generator`` (a
    ``torch.Generator`` on the labels' device) unless ``pos_keys`` /
    ``neg_keys`` (..., N) are given.

    Fixed slot layout: positives fill slots [0, num_pos), negatives
    [num_pos, num_pos + num_neg). Returns idx (..., num_samples) int64
    (arbitrary in unused slots), is_valid, is_positive (bool).
    """
    n = labels.shape[-1]
    dev = labels.device
    pos_mask = labels == 1
    neg_mask = labels == 0
    num_pos_target = int(num_samples * positive_fraction)
    num_pos = torch.clamp(pos_mask.sum(-1, keepdim=True), max=num_pos_target)
    num_neg = torch.minimum(num_samples - num_pos, neg_mask.sum(-1, keepdim=True))

    if pos_keys is None:
        pos_keys = torch.rand(labels.shape, generator=generator, device=dev)
    if neg_keys is None:
        neg_keys = torch.rand(labels.shape, generator=generator, device=dev)
    minus = torch.full_like(pos_keys, -1.0)
    kcap = min(num_samples, n)
    _, pos_order = topk_stable(torch.where(pos_mask, pos_keys, minus), kcap)
    _, neg_order = topk_stable(torch.where(neg_mask, neg_keys, minus), kcap)

    slot = torch.arange(num_samples, device=dev).expand(
        labels.shape[:-1] + (num_samples,))
    pos_idx = torch.gather(pos_order, -1, torch.clamp(slot, max=kcap - 1))
    is_pos_slot = slot < num_pos
    neg_idx = torch.gather(neg_order, -1, torch.clamp(slot - num_pos, 0, kcap - 1))
    is_neg_slot = (slot >= num_pos) & (slot < num_pos + num_neg)
    idx = torch.where(is_pos_slot, pos_idx, neg_idx)
    return idx, is_pos_slot | is_neg_slot, is_pos_slot
