"""Mask utilities (counterpart of ``u2seg_tpu/structures/masks.py``):
polygon rasterisation on the host, boxes and areas of bitmasks, and the
box crop-and-resize of mask targets.

The JAX package rasterises COCO polygons with OpenCV's ``fillPoly`` on the
points ``round(p - 0.5)``. The port has no OpenCV. ``polygons_to_bitmask``
draws the same integer points in numpy, by the rule that OpenCV 5.0's
``fillPoly`` (8-connected) follows for polygons inside the image:

1. every edge is drawn as an 8-connected Bresenham line between its integer
   end points, clipped to the image first (OpenCV's ``LineIterator`` with
   ``leftToRight``);
2. every non-horizontal edge steps over rows ``[y_top, y_bottom)`` in 16.16
   fixed point: x starts at its upper end point and moves by
   ``(dx << 16) / dy`` (truncated) per row;
3. the edges of all polygons of one object are filled together: on each
   row the edges sorted by x pair up, and each pair fills the pixels whose
   centres lie between them, ``[ceil(x_left), floor(x_right)]``. Polygons of
   one object therefore overlap by parity.

Inside the image this is ``fillPoly`` bit for bit. Where a polygon crosses
the image border, OpenCV clips its edges by rules this module reproduces in
part (an edge whose clipped segment lies on one row), and a few pixels near
the border differ (the shares are pinned in ``tests/test_torch_masks.py``).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` on a ``w x h`` image: (inside, x1, y1, x2, y2),
    the end points moved onto the image border where the segment leaves it
    (in OpenCV's order of operations, with its double arithmetic)."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _outside(w: int, h: int, x: int, y: int) -> bool:
    return not (0 <= x < w and 0 <= y < h)


def _line_pixels(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """(ys, xs) of OpenCV's 8-connected line from (x1, y1) to (x2, y2),
    clipped to the image, walked left to right."""
    if _outside(w, h, x1, y1) or _outside(w, h, x2, y2):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:                                  # leftToRight
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    # Bresenham with err0 = major - 2 minor: the minor step k is
    # ceil((2 minor k - major) / (2 major))
    m = (2 * minor * k + major - 1) // (2 * major) if major else k
    if dy > dx:
        return y1 + sy * k, x1 + m
    return y1 + sy * m, x1 + k


def _collect_edges(w: int, h: int, pts: np.ndarray, lines: list, edges: list) -> None:
    """One polygon's lines and scanline edges [y0, y1, x, dx]. An edge that
    leaves the image and whose clipped segment lies on one row keeps its
    rows but takes the clipped segment's x at its two ends."""
    n = len(pts)
    px, py = int(pts[n - 1, 0]), int(pts[n - 1, 1])
    for i in range(n):
        qx, qy = int(pts[i, 0]), int(pts[i, 1])
        lines.append(_line_pixels(w, h, px, py, qx, qy))
        if py != qy:
            ex0, ex1 = px, qx
            if _outside(w, h, px, py) or _outside(w, h, qx, qy):
                _, tx0, ty0, tx1, ty1 = _clip_line(w, h, px, py, qx, qy)
                if ty0 == ty1:
                    ex0, ex1 = tx0, tx1
            (x0, y0), (x1, y1) = sorted(((ex0, py), (ex1, qy)), key=lambda p: p[1])
            edges.append([y0, y1, x0 << XY_SHIFT,
                          _trunc_div((x1 - x0) << XY_SHIFT, y1 - y0)])
        px, py = qx, qy


def _fill(mask: np.ndarray, e: np.ndarray) -> None:
    """Scanline fill of edges [y0, y1, x, dx]: every row crosses an even
    number of edges, so the sorted x of a row pair up."""
    h, w = mask.shape
    y0, y1, x0, dx = e.T
    lo, hi = np.maximum(y0, 0), np.minimum(y1, h)
    n = np.maximum(hi - lo, 0)
    if not n.any():
        return
    idx = np.repeat(np.arange(len(e)), n)
    ys = np.repeat(lo, n) + (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n))
    xs = x0[idx] + (ys - y0[idx]) * dx[idx]
    order = np.lexsort((xs, ys))
    ys, xs = ys[order][0::2], xs[order]
    x1 = (xs[0::2] + XY_ONE - 1) >> XY_SHIFT
    x2 = xs[1::2] >> XY_SHIFT
    keep = (x1 < w) & (x2 >= 0) & (x1 <= x2)
    ys, x1, x2 = ys[keep], np.maximum(x1[keep], 0), np.minimum(x2[keep], w - 1)
    diff = np.zeros(h * (w + 1) + 1, np.int32)
    np.add.at(diff, ys * (w + 1) + x1, 1)
    np.add.at(diff, ys * (w + 1) + x2 + 1, -1)
    mask |= np.cumsum(diff[:-1]).reshape(h, w + 1)[:, :w] > 0


def polygons_to_bitmask(polygons: Sequence[np.ndarray], height: int, width: int) -> np.ndarray:
    """COCO polygons ([x0, y0, x1, y1, ...], several per object) -> bool
    (height, width) mask, as ``cv2.fillPoly`` draws them on the integer
    points ``round(p - 0.5)`` (numpy rounds halves to even)."""
    mask = np.zeros((height, width), dtype=bool)
    pts = [np.asarray(p, dtype=np.float64).reshape(-1, 2) for p in polygons if len(p) >= 6]
    if not pts:
        return mask
    lines: list = []
    edges: List[list] = []
    for p in pts:
        _collect_edges(width, height, np.round(p - 0.5).astype(np.int32), lines, edges)
    for ys, xs in lines:
        mask[ys, xs] = True
    if len(edges) < 2:
        return mask
    e = np.asarray(edges, dtype=np.int64)
    x_end = e[:, 2] + (e[:, 1] - e[:, 0]) * e[:, 3]
    if (e[:, 1].max() < 0 or e[:, 0].min() >= height
            or max(e[:, 2].max(), x_end.max()) < 0
            or min(e[:, 2].min(), x_end.min()) >= width << XY_SHIFT):
        return mask
    _fill(mask, e)
    return mask


def bitmask_areas(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) -> (N,) pixel counts (int32)."""
    return masks.to(torch.int32).sum(dim=(-2, -1), dtype=torch.int32)


def bitmasks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """Tight XYXY boxes (float32) of (N, H, W) bool masks; zeros for empty
    masks (ref ``BitMasks.get_bounding_boxes``)."""
    masks = np.asarray(masks, bool)
    boxes = np.zeros((masks.shape[0], 4), dtype=np.float32)
    rows, cols = masks.any(axis=2), masks.any(axis=1)
    for i in range(masks.shape[0]):
        ys, xs = np.flatnonzero(rows[i]), np.flatnonzero(cols[i])
        if len(xs):
            boxes[i] = [xs[0], ys[0], xs[-1] + 1, ys[-1] + 1]
    return boxes


def crop_and_resize(masks: torch.Tensor, boxes: torch.Tensor, mask_size: int) -> torch.Tensor:
    """Crop each full-image mask by its box and resample to (mask_size,
    mask_size) with aligned bilinear ROIAlign, 2 x 2 samples per bin (the
    mask-head target op, ref ``BitMasks.crop_and_resize``): (N, H, W) float
    or bool masks, (N, 4) XYXY boxes -> (N, mask_size, mask_size) f32."""
    from u2seg_torch.ops.roi_align import roi_align

    n = masks.shape[0]
    feats = masks.to(torch.float32)[..., None]            # (N, H, W, 1)
    idx = torch.arange(n, dtype=torch.int32, device=masks.device)
    out = roi_align(feats, boxes, idx, output_size=mask_size, spatial_scale=1.0,
                    sampling_ratio=0)
    return out[..., 0]
