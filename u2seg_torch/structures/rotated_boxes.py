"""Rotated boxes (cx, cy, w, h, angle in degrees counter-clockwise) with
exact pairwise IoU (counterpart of ``u2seg_tpu/structures/rotated_boxes.py``;
detectron2's ``structures/rotated_boxes.py`` and its ``box_iou_rotated`` /
``nms_rotated`` ops).

The intersection of two rotated rectangles is one rectangle clipped against
the other's four half-planes (Sutherland-Hodgman) at a fixed vertex
capacity, on tensors: every pair of an (N, M) IoU matrix at once, no host
loop. The clipping keeps the JAX package's slot order and its stable
compaction, so the polygons (and their areas) are the same.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from u2seg_torch.ops.nms import topk_stable

MAX_VERTS = 16  # 8 suffice for a rectangle clipped by a rectangle


def corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) rotated boxes -> (..., 4, 2) corner points:
    ``p = centre + [[c, s], [-s, c]] @ (lx, ly)`` (y grows downward)."""
    cx, cy, w, h, a = boxes.unbind(-1)
    t = torch.deg2rad(a)
    cos, sin = torch.cos(t), torch.sin(t)
    lx = torch.stack([-w, w, w, -w], -1) * 0.5
    ly = torch.stack([-h, -h, h, h], -1) * 0.5
    px = lx * cos[..., None] + ly * sin[..., None] + cx[..., None]
    py = -lx * sin[..., None] + ly * cos[..., None] + cy[..., None]
    return torch.stack([px, py], dim=-1)


def area(boxes: torch.Tensor) -> torch.Tensor:
    return boxes[..., 2] * boxes[..., 3]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx[...]] along the vertex axis (x: (..., V) or (..., V, 2))."""
    if x.dim() == idx.dim():
        return torch.gather(x, -1, idx)
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + (x.shape[-1],)))


def _clip_halfplane(pts, valid, a, b, c):
    """Clip polygons (pts (..., V, 2), valid (..., V)) against the
    half-planes ``a*x + b*y + c >= 0`` (a, b, c: (...,)). Each edge i -> i+1
    emits its crossing point (slot 2i) and its end point if inside (slot
    2i + 1); the emitted points are compacted by a stable sort."""
    v = MAX_VERTS
    count = valid.sum(-1, keepdim=True)
    s = a[..., None] * pts[..., 0] + b[..., None] * pts[..., 1] + c[..., None]
    inside = s >= 0
    idx = torch.arange(v, device=pts.device)
    nxt = torch.where(idx + 1 < count, idx + 1, torch.zeros_like(idx)).expand(s.shape)
    p_j, s_j, in_j = _take(pts, nxt), _take(s, nxt), _take(inside, nxt)
    edge_valid = idx < count
    den = s - s_j
    t = s / torch.where(torch.abs(den) > 1e-12, den, torch.full_like(den, 1e-12))
    inter = pts + (p_j - pts) * torch.clamp(t, 0.0, 1.0)[..., None]
    out_pts = torch.stack([inter, p_j], dim=-2).flatten(-3, -2)          # (..., 2V, 2)
    out_val = torch.stack([edge_valid & (inside != in_j), edge_valid & in_j],
                          dim=-1).flatten(-2)
    order = torch.sort((~out_val).to(torch.uint8), dim=-1, stable=True)[1][..., :v]
    return _take(out_pts, order), _take(out_val, order)


def _poly_area(pts, valid):
    """Shoelace area of each polygon's valid prefix."""
    count = valid.sum(-1, keepdim=True)
    idx = torch.arange(MAX_VERTS, device=pts.device)
    nxt = torch.where(idx + 1 < count, idx + 1, torch.zeros_like(idx)).expand(valid.shape)
    x, y = pts[..., 0], pts[..., 1]
    contrib = x * _take(y, nxt) - _take(x, nxt) * y
    contrib = torch.where(idx < count, contrib, torch.zeros_like(contrib))
    return 0.5 * torch.abs(contrib.sum(-1))


def _intersection_area(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Intersection areas of broadcast pairs of rotated boxes (..., 5)."""
    c1, c2 = corners(b1), corners(b2)
    shape = torch.broadcast_shapes(c1.shape[:-2], c2.shape[:-2])
    c1, c2 = c1.expand(shape + (4, 2)), c2.expand(shape + (4, 2))
    pts = torch.cat([c1, c1.new_zeros(shape + (MAX_VERTS - 4, 2))], dim=-2)
    valid = torch.arange(MAX_VERTS, device=b1.device).expand(shape + (MAX_VERTS,)) < 4
    center = c2.mean(dim=-2)
    for k in range(4):
        p, q = c2[..., k, :], c2[..., (k + 1) % 4, :]
        a = q[..., 1] - p[..., 1]
        b = -(q[..., 0] - p[..., 0])
        c = -(a * p[..., 0] + b * p[..., 1])
        # orient the half-plane so that the rectangle's centre is inside
        flip = torch.where(a * center[..., 0] + b * center[..., 1] + c < 0, -1.0, 1.0)
        pts, valid = _clip_halfplane(pts, valid, a * flip, b * flip, c * flip)
    return _poly_area(pts, valid)


def pairwise_iou_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N, 5) x (M, 5) -> (N, M) exact rotated IoU, in the boxes' dtype."""
    inter = _intersection_area(boxes1[:, None], boxes2[None, :])
    union = area(boxes1)[:, None] + area(boxes2)[None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12),
                       torch.zeros_like(inter))


def nms_rotated(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                max_output: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS on rotated boxes: candidates in stable order of -score
    (invalid ones carry -inf), the upper-triangular IoU matrix, the greedy
    pass, the top ``min(max_output, N)`` survivors. Returns (indices into the
    input, int32; valid, bool).

    The greedy pass ("a box is suppressed iff an earlier kept box overlaps
    it above the threshold") is solved as a fixpoint over whole vectors:
    ``sup <- any_i(over[i] & ~sup[i])`` from ``sup = 0``. After k rounds the
    first k boxes are final, so it reaches the greedy answer (its unique
    fixed point) in at most N + 1 rounds, typically as many as the longest
    chain of suppressions; one host sync per round, none per box."""
    n = boxes.shape[0]
    order = torch.sort(-scores, stable=True)[1]
    sb, ss = boxes[order], scores[order]
    valid = ss > -math.inf
    iou = pairwise_iou_rotated(sb, sb)
    tri = torch.ones((n, n), dtype=torch.bool, device=boxes.device).triu(1)
    over = tri & valid[None, :] & valid[:, None] & (iou > iou_threshold)
    sup = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    for _ in range(n + 1):
        new = (over & ~sup[:, None]).any(dim=0)
        if torch.equal(new, sup):
            break
        sup = new
    keep_scores = torch.where(~sup & valid, ss, torch.full_like(ss, -math.inf))
    top_s, top_i = topk_stable(keep_scores, min(max_output, n))
    return order[top_i].to(torch.int32), top_s > -math.inf


def clip_rotated(boxes: torch.Tensor, image_hw, clip_angle_threshold: float = 1.0):
    """Clip the near-axis-aligned boxes (|angle| <= threshold, modulo 360)
    to the image; the others are left as they are."""
    h, w = image_hw[0], image_hw[1]
    cx, cy, bw, bh, a = boxes.unbind(-1)
    x0 = torch.clamp(cx - bw / 2, 0, w)
    x1 = torch.clamp(cx + bw / 2, 0, w)
    y0 = torch.clamp(cy - bh / 2, 0, h)
    y1 = torch.clamp(cy + bh / 2, 0, h)
    clipped = torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0, a], dim=-1)
    near_axis = torch.abs(torch.remainder(a + 180, 360) - 180)[..., None] <= clip_angle_threshold
    return torch.where(near_axis, clipped, boxes)


def get_deltas_rotated(src: torch.Tensor, target: torch.Tensor,
                       weights=(1.0, 1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """(dx, dy, dw, dh, da) between (cx, cy, w, h, angle) boxes; da taken
    into [-180, 180) degrees, then to radians."""
    wx, wy, ww, wh, wa = weights
    dx = wx * (target[..., 0] - src[..., 0]) / torch.clamp(src[..., 2], min=1e-6)
    dy = wy * (target[..., 1] - src[..., 1]) / torch.clamp(src[..., 3], min=1e-6)
    dw = ww * torch.log(target[..., 2] / torch.clamp(src[..., 2], min=1e-6))
    dh = wh * torch.log(target[..., 3] / torch.clamp(src[..., 3], min=1e-6))
    da = target[..., 4] - src[..., 4]
    da = torch.remainder(da + 180.0, 360.0) - 180.0
    da = wa * da * math.pi / 180.0
    return torch.stack([dx, dy, dw, dh, da], dim=-1)


def apply_deltas_rotated(deltas: torch.Tensor, boxes: torch.Tensor,
                         weights=(1.0, 1.0, 1.0, 1.0, 1.0),
                         scale_clamp: float = math.log(1000.0 / 16)) -> torch.Tensor:
    wx, wy, ww, wh, wa = weights
    cx = boxes[..., 0] + deltas[..., 0] / wx * boxes[..., 2]
    cy = boxes[..., 1] + deltas[..., 1] / wy * boxes[..., 3]
    w = boxes[..., 2] * torch.exp(torch.clamp(deltas[..., 2] / ww, max=scale_clamp))
    h = boxes[..., 3] * torch.exp(torch.clamp(deltas[..., 3] / wh, max=scale_clamp))
    a = boxes[..., 4] + deltas[..., 4] / wa * 180.0 / math.pi
    a = torch.remainder(a + 180.0, 360.0) - 180.0
    return torch.stack([cx, cy, w, h, a], dim=-1)
