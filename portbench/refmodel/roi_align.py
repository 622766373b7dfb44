"""Single-level ROIAlign (``roi_align``: the mask head's targets from the
ground truth's patches) and the FPN level routing (``log2``,
``assign_boxes_to_levels``) of the port's gather pooler. ROIAlignV2
semantics (aligned=True): samples outside [-1, size] contribute 0, the rest
clamp into [0, size-1]; outputs are f32."""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.refmodel.consts import scalar
from portbench.refmodel import boxes as box_ops


def log2(x: torch.Tensor) -> torch.Tensor:
    """``log(x) / log(2)`` — how ``jnp.log2`` computes it. Level routing
    floors this value, so it keeps the JAX package's op order."""
    return torch.log(x) / scalar(math.log(2.0), x.device)


def _sample_coords_1d(start, bin_size, num_bins: int, ratio: int):
    """Centers of ``ratio`` samples in each of ``num_bins`` bins along one
    axis: (..., num_bins * ratio)."""
    i = torch.arange(num_bins * ratio, device=start.device)
    offs = torch.div(i, ratio, rounding_mode="floor").to(torch.float32)
    sub = ((i % ratio).to(torch.float32) + 0.5) / ratio
    rel = offs + sub
    return start[..., None] + rel * bin_size[..., None]


def roi_align(
    features: torch.Tensor,
    boxes: torch.Tensor,
    batch_idx: torch.Tensor,
    output_size: int,
    spatial_scale: float,
    sampling_ratio: int = 0,
) -> torch.Tensor:
    """Single-level aligned ROIAlign on (B, H, W, C) features -> f32
    (R, S, S, C); ``sampling_ratio <= 0`` means 2."""
    if sampling_ratio <= 0:
        sampling_ratio = 2
    s, r = output_size, sampling_ratio
    b, h, w, c = features.shape
    n_roi = boxes.shape[0]
    fb = boxes.to(torch.float32) * spatial_scale
    div = scalar(s, boxes.device)
    xs = _sample_coords_1d(fb[:, 0] - 0.5, (fb[:, 2] - fb[:, 0]) / div, s, r)
    ys = _sample_coords_1d(fb[:, 1] - 0.5, (fb[:, 3] - fb[:, 1]) / div, s, r)
    full = lambda v: torch.full((n_roi,), v, device=boxes.device)
    return _pool_samples(
        features.reshape(b * h * w, c), batch_idx.to(torch.int64) * (h * w),
        full(w), ys, xs, full(float(h)), full(float(w)), s, r)


def assign_boxes_to_levels(
    boxes: torch.Tensor,
    min_level: int,
    max_level: int,
    canonical_box_size: float = 224.0,
    canonical_level: int = 4,
) -> torch.Tensor:
    """FPN level assignment ``floor(4 + log2(sqrt(area)/224 + 1e-8))``,
    clipped to [min_level, max_level]. (R,) int32."""
    sqrt_area = torch.sqrt(torch.clamp(box_ops.area(boxes), min=1e-12))
    lvl = torch.floor(canonical_level + log2(
        sqrt_area / scalar(canonical_box_size, boxes.device) + 1e-8))
    return torch.clamp(lvl, min_level, max_level).to(torch.int32)


def _axis_interp(coords, size):
    """Corner indices and weights along one axis; size: (R,) f32."""
    size = size[:, None]
    inside = (coords >= -1.0) & (coords <= size)
    cc = torch.minimum(torch.clamp(coords, min=0.0), size - 1)
    lo = torch.floor(cc)
    frac = cc - lo
    lo_i = lo.to(torch.int64)
    hi_i = torch.minimum(lo_i + 1, size.to(torch.int64) - 1)
    zero = torch.zeros_like(frac)
    w_lo = torch.where(inside, 1.0 - frac, zero)
    w_hi = torch.where(inside, frac, zero)
    return lo_i, hi_i, w_lo, w_hi


def _pool_samples(flat, base, row_w, ys, xs, h_r, w_r, s: int, r: int):
    """Blend the 4 bilinear corners of every (ys, xs) sample from ``flat``
    (rows ``base + y * row_w + x``) and mean-pool r x r samples per bin."""
    n_roi, c = ys.shape[0], flat.shape[-1]
    yx0, yx1, wy0, wy1 = _axis_interp(ys, h_r)
    xx0, xx1, wx0, wx1 = _axis_interp(xs, w_r)

    def gather_hw(yi, xi):
        lin = (base[:, None, None] + yi[:, :, None] * row_w[:, None, None]
               + xi[:, None, :])
        return flat[lin.reshape(-1)].reshape(n_roi, s * r, s * r, c)

    wy0e, wy1e = wy0[:, :, None, None], wy1[:, :, None, None]
    wx0e, wx1e = wx0[:, None, :, None], wx1[:, None, :, None]
    samples = (
        gather_hw(yx0, xx0) * (wy0e * wx0e)
        + gather_hw(yx0, xx1) * (wy0e * wx1e)
        + gather_hw(yx1, xx0) * (wy1e * wx0e)
        + gather_hw(yx1, xx1) * (wy1e * wx1e)
    )
    return samples.reshape(n_roi, s, r, s, r, c).mean(dim=(2, 4))
