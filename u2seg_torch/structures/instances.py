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
    """

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
    mask_logits: Optional[torch.Tensor] = None


@dataclasses.dataclass
class GtInstances:
    """Ground-truth instances of a batch, padded to a fixed capacity N.

    boxes:   (B, N, 4) XYXY in the network input's coordinate frame.
    classes: (B, N) int contiguous class ids (0..C-1).
    valid:   (B, N) bool.
    masks:   (B, N, P, P) optional masks cropped to their gt box (patches),
             values in [0, 1].
    """

    boxes: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
    masks: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.boxes.shape[-2]

    def to(self, device) -> "GtInstances":
        return GtInstances(
            self.boxes.to(device), self.classes.to(device),
            self.valid.to(device),
            None if self.masks is None else self.masks.to(device))
