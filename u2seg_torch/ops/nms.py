"""Greedy NMS in the JAX package's tiled-fixpoint form, on tensors.

Counterpart of ``u2seg_tpu/ops/nms.py``. The result is defined by that
algorithm, not by a textbook greedy loop, so it is reproduced step for step:

- candidates are sorted by a STABLE sort on ``-scores`` (ties keep the lower
  index first);
- they are cut into tiles of ``NMS_TILE``; a box is suppressed if any box
  that survived an earlier tile overlaps it above the threshold;
- inside a tile, suppression is the fixpoint "boxes that are themselves
  suppressed lose their power to suppress", iterated from "every box has
  power" until the power set stops changing. A suppressed box's power is
  never restored, exactly as in the JAX tile loop;
- a box survives only if it is not suppressed AND has a non-zero
  coordinate (the JAX package tests survival on the zeroed box buffer, so
  an all-zero box never survives).

Every function takes a leading batch of independent problems: boxes
``(..., N, 4)``, scores ``(..., N)``. The fixpoint is idempotent once
converged, so one loop serves the whole batch.
"""
from __future__ import annotations

from typing import Tuple

import torch

from u2seg_torch.structures.boxes import pairwise_iou

NMS_TILE = 256


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties broken by the lower index first (the
    order ``lax.top_k`` returns; ``torch.topk`` does not promise one)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.library.custom_op("u2seg_torch::nms_self_suppression", mutates_args=())
def _self_suppression(iou: torch.Tensor, threshold: float) -> torch.Tensor:
    """iou: (M, T, T), non-zero only above the diagonal (row suppresses
    column). Returns bool (M, T): suppressed.

    A registered op: its loop reads the power set back to the host every
    round, which ``torch.export`` cannot trace; the export records one node
    whose output shape the fake implementation below gives."""
    over = iou > threshold
    power = torch.ones(iou.shape[:-1], dtype=torch.bool, device=iou.device)
    while True:
        sup = (over & power[..., :, None]).any(dim=-2)
        new_power = power & ~sup
        if torch.equal(new_power, power):
            return sup
        power = new_power


@_self_suppression.register_fake
def _(iou, threshold):
    return iou.new_empty(iou.shape[:-1], dtype=torch.bool)


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_output: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS.

    Args:
      boxes: (..., N, 4) XYXY. Invalid entries carry score -inf.
      scores: (..., N).
    Returns:
      keep_idx: (..., max_output) int32 indices into the input,
        score-descending; keep_valid: (..., max_output) bool.
    """
    lead = boxes.shape[:-2]
    n = boxes.shape[-2]
    boxes = boxes.reshape(-1, n, 4)
    scores = scores.reshape(-1, n)
    m = boxes.shape[0]

    order = torch.sort(-scores, dim=-1, stable=True)[1]
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    sscores = torch.gather(scores, 1, order)
    valid = sscores > -float("inf")
    sboxes = torch.where(valid[..., None], sboxes, torch.zeros_like(sboxes))

    tile = NMS_TILE
    num_tiles = (n + tile - 1) // tile
    padded = torch.zeros((m, num_tiles * tile, 4), dtype=sboxes.dtype,
                         device=sboxes.device)
    padded[:, :n] = sboxes
    tri = torch.triu(torch.ones((tile, tile), dtype=torch.bool,
                                device=boxes.device), diagonal=1)
    for i in range(num_tiles):
        bt = padded[:, i * tile:(i + 1) * tile]
        if i > 0:
            # every box that survived an earlier tile (suppressed ones are
            # zero and overlap nothing)
            prev = padded[:, :i * tile]
            sup = (pairwise_iou(prev, bt) > iou_threshold).any(dim=-2)
            bt = bt * (~sup)[..., None].to(bt.dtype)
        iou = pairwise_iou(bt, bt)
        iou = torch.where(tri, iou, torch.zeros_like(iou))
        sup_self = _self_suppression(iou, iou_threshold)
        padded[:, i * tile:(i + 1) * tile] = bt * (~sup_self)[..., None].to(bt.dtype)

    final = padded[:, :n]
    survived = (final != 0.0).any(dim=-1) & valid
    keep_scores = torch.where(survived, sscores,
                              torch.full_like(sscores, -float("inf")))
    top_scores, top_pos = topk_stable(keep_scores, max_output)
    keep_idx = torch.gather(order, 1, top_pos).to(torch.int32)
    keep_valid = top_scores > -float("inf")
    return (keep_idx.reshape(lead + (max_output,)),
            keep_valid.reshape(lead + (max_output,)))


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
    max_output: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS via the coordinate-offset trick, one problem per row
    of the leading axes: boxes of different ``idxs`` never suppress each
    other. The offset is computed in the boxes' dtype with the JAX
    package's op order: ``span = max - min + 1``; ``box + id * span``."""
    span = (boxes.amax(dim=(-2, -1)) - boxes.amin(dim=(-2, -1)) + 1.0)
    offsets = idxs.to(boxes.dtype) * span[..., None]
    shifted = boxes + offsets[..., None]
    return nms(shifted, scores, iou_threshold, max_output)
