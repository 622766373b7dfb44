"""COCO run-length-encoding codec and mask operations (counterpart of
``u2seg_tpu/evaluation/rle.py``): encode/decode/area for the predictor's
records; merge, iou, to_bbox and frPyObjects (polygon rasterisation with
pycocotools' ``rleFrPoly`` walk) for the COCO API and COCOeval. ``iou``
runs in the host C++ of ``u2seg_torch/_native`` (built with g++ at first
use; it raises where it cannot be built); ``_iou_plain`` is its numpy twin.
Everything else here is numpy.

The wire format is pycocotools': column-major (Fortran) run lengths that
start with a background run, compressed to the 6-bit delta string of
``rleToString``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

from u2seg_torch import _native

RLE = Dict[str, Union[bytes, str, List[int], Sequence[int]]]


def counts_to_string(counts: Sequence[int]) -> bytes:
    s = bytearray()
    for i in range(len(counts)):
        x = int(counts[i])
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            s.append(c + 48)
    return bytes(s)


def string_to_counts(s: Union[bytes, str]) -> List[int]:
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    p = 0
    n = len(s)
    while p < n:
        x = 0
        k = 0
        more = True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode(mask: np.ndarray) -> RLE:
    """Binary (H, W) mask -> compressed RLE dict (like mask_util.encode)."""
    h, w = mask.shape
    flat = np.asfortranarray(mask).ravel(order="F").astype(np.uint8)
    if flat.size == 0:
        counts: List[int] = [0]
    else:
        change = np.nonzero(np.diff(flat))[0] + 1
        bounds = np.concatenate([[0], change, [flat.size]])
        counts = np.diff(bounds).tolist()
        if flat[0] == 1:       # the first run counts zeros, possibly none
            counts = [0] + counts
    return {"size": [h, w], "counts": counts_to_string(counts)}


def _ensure_counts(rle: RLE) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = string_to_counts(counts)
    return np.asarray(counts, dtype=np.int64)


def decode(rle: RLE) -> np.ndarray:
    """RLE dict -> binary (H, W) uint8 mask. Accepts compressed (string) or
    uncompressed (list) counts."""
    h, w = rle["size"]
    counts = _ensure_counts(rle)
    vals = np.zeros(len(counts), dtype=np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    if flat.size != h * w:
        flat = np.resize(flat, h * w)
    return flat.reshape((w, h)).T  # column-major


def area(rle: RLE) -> int:
    return int(_ensure_counts(rle)[1::2].sum())


def merge(rles: Sequence[RLE], intersect: bool = False) -> RLE:
    """Union (or intersection) of masks (like mask_util.merge)."""
    if not rles:
        return {"size": [0, 0], "counts": b""}
    out = decode(rles[0]).astype(bool)
    for r in rles[1:]:
        m = decode(r).astype(bool)
        out = (out & m) if intersect else (out | m)
    return encode(out.astype(np.uint8))


def iou(dt: Sequence[RLE], gt: Sequence[RLE], iscrowd: Sequence[int]) -> np.ndarray:
    """Pairwise mask IoU matrix (D, G), crowd gt uses inter/area(dt)
    (mask_util.iou semantics): the run lists merge-walked in C++
    (``_native.iou``), equal to ``_iou_plain``."""
    return _native.iou(dt, gt, iscrowd)


def _iou_plain(dt: Sequence[RLE], gt: Sequence[RLE], iscrowd: Sequence[int]) -> np.ndarray:
    """``iou`` in numpy: every mask decoded, every pair ANDed (the reference
    of the C++ one)."""
    d, g = len(dt), len(gt)
    out = np.zeros((d, g), dtype=np.float64)
    if d == 0 or g == 0:
        return out
    d_areas = [area(r) for r in dt]
    g_areas = [area(r) for r in gt]
    d_masks = [decode(r).astype(bool) for r in dt]
    g_masks = [decode(r).astype(bool) for r in gt]
    for i in range(d):
        for j in range(g):
            inter = int(np.count_nonzero(d_masks[i] & g_masks[j]))
            if iscrowd[j]:
                denom = d_areas[i]
            else:
                denom = d_areas[i] + g_areas[j] - inter
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out


def to_bbox(rle: RLE) -> np.ndarray:
    """Tight XYWH bbox of an RLE (mask_util.toBbox)."""
    m = decode(rle)
    ys, xs = np.nonzero(m)
    if len(xs) == 0:
        return np.zeros(4)
    return np.array(
        [xs.min(), ys.min(), xs.max() - xs.min() + 1, ys.max() - ys.min() + 1],
        dtype=np.float64,
    )


def frPyObjects(obj, h: int, w: int):
    """Polygons / uncompressed RLE / bbox -> RLE (mask_util.frPyObjects)."""
    if isinstance(obj, dict):
        counts = obj["counts"]
        if isinstance(counts, list):
            return {"size": obj["size"], "counts": counts_to_string(counts)}
        return obj
    if isinstance(obj, (list, tuple)) and len(obj) and isinstance(
        obj[0], (list, tuple, np.ndarray)
    ):
        # list of polygons -> list of RLEs
        return [_poly_to_rle(np.asarray(p, np.float64), h, w) for p in obj]
    if isinstance(obj, (list, tuple, np.ndarray)):
        arr = np.asarray(obj, dtype=np.float64)
        if arr.ndim == 1 and arr.size >= 6:
            return _poly_to_rle(arr, h, w)
    raise TypeError(f"Unsupported object for frPyObjects: {type(obj)}")


def _poly_to_rle(poly: np.ndarray, h: int, w: int) -> RLE:
    """Rasterize one polygon ([x0,y0,x1,y1,...]) to RLE.

    Uses the same upsample-by-5 integer edge walk as pycocotools' rleFrPoly
    so rasterization matches the reference bit-for-bit.
    """
    xy = poly.reshape(-1, 2)
    k = xy.shape[0]
    scale = 5.0
    x = np.floor(scale * xy[:, 0] + 0.5).astype(np.int64)
    y = np.floor(scale * xy[:, 1] + 0.5).astype(np.int64)
    x = np.append(x, x[0])
    y = np.append(y, y[0])

    # upsampled boundary points via integer line walk (rleFrPoly)
    u_list: List[int] = []
    v_list: List[int] = []
    for j in range(k):
        xs_, xe = int(x[j]), int(x[j + 1])
        ys_, ye = int(y[j]), int(y[j + 1])
        dx = abs(xe - xs_)
        dy = abs(ys_ - ye)
        flip = (dx >= dy and xs_ > xe) or (dx < dy and ys_ > ye)
        if flip:
            xs_, xe = xe, xs_
            ys_, ye = ye, ys_
        if dx >= dy:
            s = (ye - ys_) / dx if dx else 0.0
            for d in range(dx + 1):
                t = xe - d if flip else xs_ + d
                u_list.append(t)
                v_list.append(int(ys_ + s * (t - xs_) + 0.5))
        else:
            s = (xe - xs_) / dy if dy else 0.0
            for d in range(dy + 1):
                t = ye - d if flip else ys_ + d
                v_list.append(t)
                u_list.append(int(xs_ + s * (t - ys_) + 0.5))

    # downsample: get points along y-boundary and downscale
    u = np.asarray(u_list, dtype=np.int64)
    v = np.asarray(v_list, dtype=np.int64)
    xd_list: List[int] = []
    yd_list: List[int] = []
    m = len(u)
    for j in range(1, m):
        if u[j] != u[j - 1]:
            # note: asymmetric select (u[j]-1 when moving right), per rleFrPoly
            xd = float(u[j] if u[j] < u[j - 1] else u[j] - 1)
            xd = (xd + 0.5) / scale - 0.5
            if np.floor(xd) != xd or xd < 0 or xd > w - 1:
                continue
            yd = float(min(v[j], v[j - 1]))
            yd = (yd + 0.5) / scale - 0.5
            if yd < 0:
                yd = 0
            elif yd > h:
                yd = h
            yd = np.ceil(yd)
            xd_list.append(int(xd))
            yd_list.append(int(yd))

    # compute rle encoding given y-boundary points
    kk = len(xd_list)
    a = [int(xd_list[j]) * int(h) + int(yd_list[j]) for j in range(kk)]
    a.append(h * w)
    a.sort()
    p = 0
    for j in range(len(a)):
        t = a[j]
        a[j] -= p
        p = t
    m2 = len(a)
    b: List[int] = [a[0]]
    j = 1
    while j < m2:
        if a[j] > 0:
            b.append(a[j])
            j += 1
        else:
            j += 1
            if j < m2:
                b[-1] += a[j]
                j += 1
    return {"size": [h, w], "counts": counts_to_string(b)}
