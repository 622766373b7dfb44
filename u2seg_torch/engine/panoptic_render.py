"""Exact full-resolution panoptic rendering on the host, in numpy
(counterpart of ``u2seg_tpu/engine/panoptic_render.py``).

- mask pasting: per-box region, bilinear with ``align_corners=False`` and
  zero padding, threshold ``>= 0.5``;
- semantic upsampling: the head's 4x bilinear upsample, then crop to the
  valid input region and bilinear resize to the original resolution, argmax
  last;
- panoptic fusion: instances painted in descending score order with the
  >50%-claimed drop rule, stuff labels fill leftover pixels when their
  unclaimed area reaches ``stuff_area_limit``; sequential segment ids.

It is the predictor's host render (and its per-image fallback) and the
yardstick the device render (``engine/device_render.py``) is held to.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from u2seg_torch.data.transforms import resize_bilinear


def _interp_axis0(v: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Bilinear sample ``v`` (A, ...) along axis 0 at float positions ``p``
    (n,), zero padding outside [0, A)."""
    a = v.shape[0]
    f = np.floor(p).astype(np.int64)
    w = (p - f).reshape((-1,) + (1,) * (v.ndim - 1)).astype(v.dtype)

    def take(i):
        out = np.zeros((len(p),) + v.shape[1:], v.dtype)
        ok = (i >= 0) & (i < a)
        out[ok] = v[i[ok]]
        return out

    return (1 - w) * take(f) + w * take(f + 1)


def paste_mask_exact(
    prob: np.ndarray,        # (M, M) float mask probabilities
    box: np.ndarray,         # (4,) float XYXY in output-image coords
    img_h: int,
    img_w: int,
) -> Tuple[slice, slice, np.ndarray]:
    """Paste one soft mask into image coords; returns (ys, xs, soft submask).

    The pasted region is the box floor-1/ceil+1 clamped to the image; sample
    positions are pixel centers mapped into mask coords."""
    m = prob.shape[0]
    x0, y0, x1, y1 = float(box[0]), float(box[1]), float(box[2]), float(box[3])
    x0i = max(int(np.floor(x0)) - 1, 0)
    y0i = max(int(np.floor(y0)) - 1, 0)
    x1i = min(int(np.ceil(x1)) + 1, img_w)
    y1i = min(int(np.ceil(y1)) + 1, img_h)
    if x1i <= x0i or y1i <= y0i or x1 <= x0 or y1 <= y0:
        return slice(0, 0), slice(0, 0), np.zeros((0, 0), prob.dtype)
    py = (np.arange(y0i, y1i, dtype=np.float64) + 0.5 - y0) / (y1 - y0) * m - 0.5
    px = (np.arange(x0i, x1i, dtype=np.float64) + 0.5 - x0) / (x1 - x0) * m - 0.5
    rows = _interp_axis0(prob.astype(np.float32), py)          # (h', M)
    sub = _interp_axis0(np.ascontiguousarray(rows.T), px).T    # (h', w')
    return slice(y0i, y1i), slice(x0i, x1i), sub


def paste_masks_full_res(
    mask_probs: np.ndarray,   # (N, M, M) float probabilities (post-sigmoid)
    boxes: np.ndarray,        # (N, 4) XYXY in output coords
    img_h: int,
    img_w: int,
    threshold: float = 0.5,
) -> np.ndarray:
    """(N, img_h, img_w) bool."""
    n = len(mask_probs)
    out = np.zeros((n, img_h, img_w), bool)
    for i in range(n):
        ys, xs, sub = paste_mask_exact(mask_probs[i], boxes[i], img_h, img_w)
        out[i, ys, xs] = sub >= threshold
    return out


def sem_seg_probs_full_res(
    logits_s4: np.ndarray,        # (H/4, W/4, C) padded stride-4 logits
    input_hw: Tuple[int, int],    # valid (h, w) at network-input resolution
    orig_hw: Tuple[int, int],
    stride: int = 4,
) -> np.ndarray:
    """(oh, ow, C) float: the two-stage bilinear chain, head 4x upsample then
    crop + resize to the original resolution."""
    h4, w4, _ = logits_s4.shape
    x = resize_bilinear(logits_s4, h4 * stride, w4 * stride)
    ih, iw = input_hw
    x = x[:ih, :iw]
    oh, ow = orig_hw
    if (oh, ow) != (ih, iw):
        x = resize_bilinear(x, oh, ow)
    return x


def combine_panoptic_full_res(
    mask_probs: np.ndarray,      # (N, M, M) float, any order
    boxes: np.ndarray,           # (N, 4) XYXY original-resolution coords
    scores: np.ndarray,          # (N,)
    classes: np.ndarray,         # (N,) contiguous thing class ids
    sem_seg: np.ndarray,         # (oh, ow) int semantic argmax labels
    instance_conf_thresh: float = 0.5,
    overlap_thresh: float = 0.5,
    stuff_area_limit: int = 4096,
    mask_threshold: float = 0.5,
) -> Tuple[np.ndarray, List[dict]]:
    """Panoptic fusion at full resolution -> (panoptic int32 (oh, ow) with
    sequential segment ids starting at 1, segments_info list of dicts)."""
    oh, ow = sem_seg.shape
    pan = np.zeros((oh, ow), np.int32)
    segments: List[dict] = []
    current_id = 0

    order = np.argsort(-np.asarray(scores, np.float64), kind="stable")
    for inst_id in order:
        score = float(scores[inst_id])
        if score < instance_conf_thresh:
            break
        ys, xs, sub = paste_mask_exact(mask_probs[inst_id], boxes[inst_id], oh, ow)
        mask = np.zeros((oh, ow), bool)
        mask[ys, xs] = sub >= mask_threshold
        mask_area = int(mask.sum())
        if mask_area == 0:
            continue
        intersect = mask & (pan > 0)
        intersect_area = int(intersect.sum())
        if intersect_area * 1.0 / mask_area > overlap_thresh:
            continue
        if intersect_area > 0:
            mask &= pan == 0
        current_id += 1
        pan[mask] = current_id
        segments.append({
            "id": current_id,
            "isthing": True,
            "score": score,
            "category_id": int(classes[inst_id]),
            "instance_id": int(inst_id),
        })

    for label in np.unique(sem_seg).tolist():
        if label == 0:  # "things" label never becomes a stuff segment
            continue
        mask = (sem_seg == label) & (pan == 0)
        mask_area = int(mask.sum())
        if mask_area < stuff_area_limit:
            continue
        current_id += 1
        pan[mask] = current_id
        segments.append({
            "id": current_id,
            "isthing": False,
            "category_id": int(label),
            "area": mask_area,
        })

    return pan, segments


def render_panoptic_output(
    boxes: np.ndarray,            # (K, 4) network-input coords
    scores: np.ndarray,
    classes: np.ndarray,
    valid: np.ndarray,
    mask_logits: Optional[np.ndarray],   # (K, M, M)
    sem_logits_s4: np.ndarray,           # (H/4, W/4, C)
    input_hw: Tuple[int, int],
    orig_hw: Tuple[int, int],
    instance_conf_thresh: float = 0.5,
    overlap_thresh: float = 0.5,
    stuff_area_limit: int = 4096,
) -> Tuple[np.ndarray, np.ndarray, List[dict]]:
    """Full eval-path render from raw model outputs: boxes rescaled to the
    original resolution, full-res semantic argmax, fusion. Returns (sem_seg
    (oh, ow) int, panoptic (oh, ow) int32, segments_info)."""
    ih, iw = input_hw
    oh, ow = orig_hw
    sel = np.asarray(valid).astype(bool)
    b = np.asarray(boxes, np.float64)[sel]
    b[:, 0::2] *= ow / iw
    b[:, 1::2] *= oh / ih
    b[:, 0::2] = b[:, 0::2].clip(0, ow)
    b[:, 1::2] = b[:, 1::2].clip(0, oh)
    probs = (
        1.0 / (1.0 + np.exp(-np.asarray(mask_logits, np.float32)[sel]))
        if mask_logits is not None
        else np.zeros((sel.sum(), 1, 1), np.float32)
    )
    sem_probs = sem_seg_probs_full_res(sem_logits_s4, input_hw, orig_hw)
    sem = sem_probs.argmax(-1).astype(np.int32)
    pan, segments = combine_panoptic_full_res(
        probs, b, np.asarray(scores)[sel], np.asarray(classes)[sel], sem,
        instance_conf_thresh=instance_conf_thresh,
        overlap_thresh=overlap_thresh,
        stuff_area_limit=stuff_area_limit,
    )
    return sem, pan, segments
