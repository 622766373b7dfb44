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
