"""The greedy instance pass of the panoptic fusion
(``models/panoptic_fpn.combine_semantic_and_instance``) as a registered op.

The pass is the fixpoint ``take <- F(take)`` of the JAX package, iterated
until it stops changing. The loop reads ``take`` back to the host every round,
which ``torch.export`` cannot trace; as the op ``u2seg_torch::
panoptic_greedy_take`` with a fake implementation (its output has the shape of
its input) the export records one node, and the loaded program runs the same
loop. Importing this module registers the op.
"""
from __future__ import annotations

import torch


def winner_map(masks: torch.Tensor, take: torch.Tensor) -> torch.Tensor:
    """(h, w): the lowest sorted slot among the taken masks covering each
    pixel, K where none does."""
    k = masks.shape[0]
    idx3 = torch.arange(k, device=masks.device)[:, None, None]
    cov = masks & take[:, None, None]
    return torch.where(cov, idx3, k).amin(dim=0)


@torch.library.custom_op("u2seg_torch::panoptic_greedy_take", mutates_args=())
def greedy_take(masks: torch.Tensor, eligible: torch.Tensor, area: torch.Tensor,
                overlap_thresh: float) -> torch.Tensor:
    """(K,) bool: the instances the greedy pass keeps, the fixpoint
    ``take <- F(take)`` from ``eligible`` over the score-sorted masks (K, h,
    w) of pixel ``area`` (K,): an instance is dropped when more than
    ``overlap_thresh`` of it is claimed by a kept one sorted before it."""
    k = masks.shape[0]
    idx3 = torch.arange(k, device=masks.device)[:, None, None]
    take = eligible
    while True:
        wm = winner_map(masks, take)
        inter = (masks & (wm[None] < idx3)).sum(dim=(1, 2))
        new = eligible & (inter / torch.clamp(area, min=1) <= overlap_thresh)
        if torch.equal(new, take):
            return take.clone()
        take = new


@greedy_take.register_fake
def _(masks, eligible, area, overlap_thresh):
    return torch.empty_like(eligible)
