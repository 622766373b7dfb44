"""Entry point: the flagship inference forward on one device.

Counterpart of ``entry()`` in the repository's ``__graft_entry__.py``: the
default ``Config()`` (R50-FPN, 3-stage cascade over 800 classes, masks, 28
sem-seg classes, bf16 compute), one 512x832 image, weights from the port's
seeded init. Runs on ``cuda`` unless ``device`` says otherwise; with no GPU
and no explicit device it raises.
"""
from __future__ import annotations

import torch

from u2seg_torch.config import Config
from u2seg_torch.models.build import build_model


def entry(device=None):
    """-> (forward, (images, sizes)); ``forward(images, sizes)`` returns
    (detection boxes, detection scores, stride-4 panoptic id map)."""
    cfg = Config()
    h, w, b = 512, 832, 1
    model = build_model(cfg, device=device)
    dev = next(model.parameters()).device
    images = torch.zeros((b, h, w, 3), dtype=torch.float32, device=dev)
    sizes = torch.tensor([[h, w]] * b, dtype=torch.int32, device=dev)

    def forward(images, sizes):
        out = model(images, sizes, combine=True)
        return out.detections.boxes, out.detections.scores, out.panoptic

    return forward, (images, sizes)
