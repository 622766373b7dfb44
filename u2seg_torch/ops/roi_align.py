"""Gather ROIAlign pooler (counterpart of ``u2seg_tpu/ops/roi_align.py``:
``roi_align``, ``assign_boxes_to_levels``, ``multilevel_roi_align``).

This is ``pooler_impl="gather"``: sqrt-area level routing, then one gather of
the 4 bilinear corners of every sample point from all levels flattened into
one buffer, and an r x r mean per bin. Features are NHWC ``(B, H, W, C)``
(channels-last views of the model's NCHW maps); outputs are f32
``(R, S, S, C)``. ROIAlignV2 semantics (aligned=True): samples outside
[-1, size] contribute 0, the rest clamp into [0, size-1].

``roi_align_rotated`` / ``multilevel_roi_align_rotated`` are ROIAlignRotated
(detectron2's ``ROIAlignRotated``, always aligned): the sample grid is laid
out in the box frame, rotated by the box angle and moved to its centre, so
the bilinear weights do not factorize and every sample gathers its 4
corners. In the JAX package these are XLA gathers, not Pallas kernels.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from u2seg_torch.ops.consts import device_table, scalar
from u2seg_torch.structures import boxes as box_ops


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


def multilevel_roi_align(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    batch_idx: torch.Tensor,
    output_size: int,
    strides: Sequence[int],
    sampling_ratio: int = 0,
    canonical_box_size: float = 224.0,
    canonical_level: int = 4,
) -> torch.Tensor:
    """ROIPooler: route each ROI to its FPN level and ROIAlign there.

    features: list of (B, H_l, W_l, C), fine -> coarse. Returns f32
    (R, S, S, C)."""
    if sampling_ratio <= 0:
        sampling_ratio = 2
    s, r = output_size, sampling_ratio
    dev = boxes.device
    min_level = int(math.log2(strides[0]))
    max_level = int(math.log2(strides[-1]))
    lvl = (assign_boxes_to_levels(boxes, min_level, max_level,
                                  canonical_box_size, canonical_level)
           - min_level).long()

    b, c = features[0].shape[0], features[0].shape[-1]
    hs = np.array([f.shape[1] for f in features], np.int64)
    ws = np.array([f.shape[2] for f in features], np.int64)
    offsets = np.concatenate([[0], np.cumsum(hs * ws)])
    total = int(offsets[-1])
    flat = torch.cat([f.reshape(b, -1, c) for f in features], dim=1)
    flat = flat.reshape(b * total, c)

    h_r = device_table(hs.tolist(), torch.float32, dev)[lvl]
    w_r = device_table(ws.tolist(), torch.float32, dev)[lvl]
    off_r = device_table(offsets[:-1].tolist(), torch.int64, dev)[lvl]
    stride_r = device_table(strides, torch.float32, dev)[lvl]
    w_int = device_table(ws.tolist(), torch.int64, dev)[lvl]

    fb = boxes.to(torch.float32) / stride_r[:, None]
    x0 = fb[:, 0] - 0.5
    y0 = fb[:, 1] - 0.5
    bin_w = (fb[:, 2] - fb[:, 0]) / scalar(s, dev)
    bin_h = (fb[:, 3] - fb[:, 1]) / scalar(s, dev)
    xs = _sample_coords_1d(x0, bin_w, s, r)                    # (R, s*r)
    ys = _sample_coords_1d(y0, bin_h, s, r)

    base = batch_idx.to(torch.int64) * total + off_r           # (R,)
    return _pool_samples(flat, base, w_int, ys, xs, h_r, w_r, s, r)


def _roi_align_rotated_rows(flat, base, row_w, h, w, scale, rois, s: int, r: int):
    """ROIAlignRotated of every ROI from ``flat`` (rows ``base + y * row_w +
    x``), each ROI on its own (h, w) map at its own ``scale`` (all (R,)
    tensors) -> f32 (R, S, S, C)."""
    n_roi, c = rois.shape[0], flat.shape[-1]
    rois = rois.to(torch.float32)
    cx = rois[:, 0] * scale - 0.5
    cy = rois[:, 1] * scale - 0.5
    rw = rois[:, 2] * scale
    rh = rois[:, 3] * scale
    theta = rois[:, 4] * (np.pi / 180.0)
    cos_t = torch.cos(theta)[:, None, None]
    sin_t = torch.sin(theta)[:, None, None]
    rel = _sample_coords_1d(torch.zeros_like(cx), torch.ones_like(cx), s, r)
    yy = (-rh / 2.0)[:, None] + rel * (rh / s)[:, None]
    xx = (-rw / 2.0)[:, None] + rel * (rw / s)[:, None]
    ys = yy[:, :, None] * cos_t - xx[:, None, :] * sin_t + cy[:, None, None]
    xs = yy[:, :, None] * sin_t + xx[:, None, :] * cos_t + cx[:, None, None]
    hf, wf = h.to(torch.float32)[:, None, None], w.to(torch.float32)[:, None, None]
    inside = (ys >= -1.0) & (ys <= hf) & (xs >= -1.0) & (xs <= wf)
    ys = torch.minimum(torch.clamp(ys, min=0.0), hf - 1.0)
    xs = torch.minimum(torch.clamp(xs, min=0.0), wf - 1.0)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = ys - y0, xs - x0
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    y1i = torch.minimum(y0i + 1, h[:, None, None] - 1)
    x1i = torch.minimum(x0i + 1, w[:, None, None] - 1)
    base, row_w = base[:, None, None], row_w[:, None, None]

    def gather(yi, xi):
        return flat[(base + yi * row_w + xi).reshape(-1)].reshape(
            n_roi, s * r, s * r, c).to(torch.float32)

    wgt = lambda a: a[..., None]  # noqa: E731
    samples = (gather(y0i, x0i) * wgt((1 - fy) * (1 - fx))
               + gather(y0i, x1i) * wgt((1 - fy) * fx)
               + gather(y1i, x0i) * wgt(fy * (1 - fx))
               + gather(y1i, x1i) * wgt(fy * fx)) * wgt(inside.to(torch.float32))
    return samples.reshape(n_roi, s, r, s, r, c).mean(dim=(2, 4))


def roi_align_rotated(
    features: torch.Tensor,
    rois: torch.Tensor,
    batch_idx: torch.Tensor,
    output_size: int,
    spatial_scale: float,
    sampling_ratio: int = 0,
) -> torch.Tensor:
    """ROIAlignRotated on (B, H, W, C) features of (R, 5) rotated boxes
    (cx, cy, w, h, angle in degrees counter-clockwise) -> f32 (R, S, S, C);
    ``sampling_ratio <= 0`` means 2. Samples outside [-1, size] weigh 0."""
    if sampling_ratio <= 0:
        sampling_ratio = 2
    b, h, w, c = features.shape
    dev, n = rois.device, rois.shape[0]
    full = lambda v, dt: torch.full((n,), v, dtype=dt, device=dev)  # noqa: E731
    return _roi_align_rotated_rows(
        features.reshape(b * h * w, c), batch_idx.to(torch.int64) * (h * w),
        full(w, torch.int64), full(h, torch.int64), full(w, torch.int64),
        full(float(spatial_scale), torch.float32), rois, output_size, sampling_ratio)


def multilevel_roi_align_rotated(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    batch_idx: torch.Tensor,
    output_size: int,
    strides: Sequence[int],
    sampling_ratio: int = 0,
    canonical_box_size: float = 224.0,
    canonical_level: int = 4,
) -> torch.Tensor:
    """The rotated ROIPooler: each ROI routed by sqrt(w * h) of its
    axis-aligned extent around the centre, then ROIAlignRotated on its
    level. The JAX package pools every ROI on every level and selects; this
    pools each ROI once, on its own level, from all levels flattened into
    one buffer (equal outputs)."""
    if sampling_ratio <= 0:
        sampling_ratio = 2
    dev = rois.device
    min_level = int(math.log2(strides[0]))
    max_level = int(math.log2(strides[-1]))
    half_w, half_h = rois[:, 2] / 2.0, rois[:, 3] / 2.0
    xyxy = torch.stack([rois[:, 0] - half_w, rois[:, 1] - half_h,
                        rois[:, 0] + half_w, rois[:, 1] + half_h], dim=1)
    lvl = (assign_boxes_to_levels(xyxy, min_level, max_level, canonical_box_size,
                                  canonical_level) - min_level).long()
    b, c = features[0].shape[0], features[0].shape[-1]
    hs = [f.shape[1] for f in features]
    ws = [f.shape[2] for f in features]
    offsets = np.concatenate([[0], np.cumsum(np.array(hs, np.int64) * np.array(ws, np.int64))])
    total = int(offsets[-1])
    flat = torch.cat([f.reshape(b, -1, c) for f in features], dim=1).reshape(b * total, c)
    h_r = device_table(hs, torch.int64, dev)[lvl]
    w_r = device_table(ws, torch.int64, dev)[lvl]
    scale_r = device_table([1.0 / float(st) for st in strides], torch.float32, dev)[lvl]
    base = (batch_idx.to(torch.int64) * total
            + device_table(offsets[:-1].tolist(), torch.int64, dev)[lvl])
    return _roi_align_rotated_rows(flat, base, w_r, h_r, w_r, scale_r, rois,
                                   output_size, sampling_ratio)
