"""Anchor generation (counterpart of ``u2seg_tpu/models/anchors.py``).

Anchors are computed in numpy, exactly as the JAX package computes them,
and cached per (shape, stride, sizes, ratios, offset, device).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from portbench.refmodel.consts import cached_constant


def cell_anchors(sizes: Sequence[float], aspect_ratios: Sequence[float]) -> np.ndarray:
    """Zero-centered base anchors, shape (A, 4) XYXY:
    area = size^2; w = sqrt(area / ratio); h = ratio * w."""
    out = []
    for size in sizes:
        area = float(size) ** 2
        for ratio in aspect_ratios:
            w = math.sqrt(area / ratio)
            h = ratio * w
            out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(out, dtype=np.float32)


def grid_anchors(
    feat_h: int, feat_w: int, stride: int,
    sizes: Sequence[float], aspect_ratios: Sequence[float],
    offset: float = 0.0,
) -> np.ndarray:
    """All anchors of one level, (H*W*A, 4): rows (y) outer, columns (x)
    middle, cell anchors (A) inner — the order of an NHWC head output
    reshaped to (H*W*A, ...)."""
    base = cell_anchors(sizes, aspect_ratios)
    shifts_x = (np.arange(feat_w, dtype=np.float32) + offset) * stride
    shifts_y = (np.arange(feat_h, dtype=np.float32) + offset) * stride
    sx, sy = np.meshgrid(shifts_x, shifts_y)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4).astype(np.float32)


def _level_anchors(h, w, stride, sizes, ratios, offset, device) -> torch.Tensor:
    return cached_constant(
        ("anchors", h, w, stride, sizes, ratios, offset, device),
        lambda: torch.from_numpy(grid_anchors(h, w, stride, sizes, ratios, offset)).to(device))


def multilevel_anchors(
    feat_shapes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    sizes_per_level: Sequence[Sequence[float]],
    aspect_ratios: Sequence[float],
    offset: float = 0.0,
    device="cpu",
) -> List[torch.Tensor]:
    """Anchors for every FPN level (list of (H_l*W_l*A, 4) tensors)."""
    return [
        _level_anchors(int(h), int(w), int(st), tuple(sizes),
                       tuple(aspect_ratios), float(offset), torch.device(device))
        for (h, w), st, sizes in zip(feat_shapes, strides, sizes_per_level)
    ]
