"""Fixed-capacity instance containers.

Counterpart of ``u2seg_tpu/structures/instances.py``: every field is padded
to a fixed capacity ``K`` with a boolean ``valid`` mask, so a batch of
images is one set of tensors with a leading batch axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Detections:
    """Model outputs per image: fixed K detections with a validity mask.

    boxes:   (B, K, 4) XYXY in network-input coordinates.
    scores:  (B, K) f32
    classes: (B, K) int32
    valid:   (B, K) bool
    mask_logits: (B, K, M, M) optional per-detection mask logits (M=28).
    keypoints: (B, K, Kp, 4) optional keypoints: x, y, heatmap logit, prob.
    """

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
    mask_logits: Optional[torch.Tensor] = None
    keypoints: Optional[torch.Tensor] = None

    def to(self, device) -> "Detections":
        return Detections(*(None if t is None else t.to(device) for t in (
            self.boxes, self.scores, self.classes, self.valid,
            self.mask_logits, self.keypoints)))


@dataclasses.dataclass
class GtInstances:
    """Ground-truth instances of a batch, padded to a fixed capacity N.

    boxes:   (B, N, 4) XYXY in the network input's coordinate frame.
    classes: (B, N) int contiguous class ids (0..C-1).
    valid:   (B, N) bool.
    masks:   (B, N, P, P) optional masks cropped to their gt box (patches),
             values in [0, 1].
    keypoints: (B, N, Kp, 3) optional keypoints: x, y, visibility (> 0 is
             visible).
    """

    boxes: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
    masks: Optional[torch.Tensor] = None
    keypoints: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.boxes.shape[-2]

    def to(self, device) -> "GtInstances":
        return GtInstances(*(None if t is None else t.to(device)
                             for t in (self.boxes, self.classes, self.valid,
                                       self.masks, self.keypoints)))

    def __getitem__(self, rows) -> "GtInstances":
        """The images ``rows`` of the batch (a slice or an index tensor)."""
        return GtInstances(*(None if t is None else t[rows]
                             for t in (self.boxes, self.classes, self.valid,
                                       self.masks, self.keypoints)))


def pad_to(x: torch.Tensor, n: int, axis: int = 0, value=0) -> torch.Tensor:
    """Pad (with ``value``) or truncate ``x`` along ``axis`` to length ``n``."""
    cur = x.shape[axis]
    if cur == n:
        return x
    if cur > n:
        return x.narrow(axis, 0, n)
    shape = list(x.shape)
    shape[axis] = n - cur
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype, device=x.device)], dim=axis)
