"""Test-time image geometry (counterpart of ``u2seg_tpu/data/transforms.py``):
what the predictor uses, in numpy.

The JAX package resizes with OpenCV (``INTER_LINEAR``). The port computes the
same float bilinear resize itself (``resize_bilinear``: half-pixel centres,
border replicate, no antialiasing) and needs no OpenCV; on float32 images
the two agree to f32 rounding.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _axis_taps(dst: int, src: int):
    """Source cells and weights of a ``src`` -> ``dst`` linear resize along
    one axis: ``coord = (i + 0.5) * src / dst - 0.5`` clamped into
    ``[0, src - 1]`` -> (lower cell (dst,), upper cell, upper weight f32)."""
    coord = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    coord = np.clip(coord, 0.0, src - 1.0)
    lo = np.floor(coord).astype(np.int64)
    hi = np.minimum(lo + 1, src - 1)
    return lo, hi, (coord - lo).astype(np.float32)


def resize_bilinear(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Float bilinear resize of ``(H, W)`` or ``(H, W, C)`` to ``(new_h,
    new_w[, C])`` in f32: columns first, then rows."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    tail = (1,) * (img.ndim - 2)
    lo, hi, t = _axis_taps(new_w, w)
    t = t.reshape((1, -1) + tail)
    img = img[:, lo] * (1.0 - t) + img[:, hi] * t
    lo, hi, t = _axis_taps(new_h, h)
    t = t.reshape((-1, 1) + tail)
    return img[lo] * (1.0 - t) + img[hi] * t


class ResizeTransform:
    """Bilinear image resize ``(h, w) -> (new_h, new_w)`` of float images."""

    def __init__(self, h: int, w: int, new_h: int, new_w: int):
        self.h, self.w, self.new_h, self.new_w = h, w, new_h, new_w

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        if (self.h, self.w) == (self.new_h, self.new_w):
            return img
        if not np.issubdtype(img.dtype, np.floating):
            raise TypeError("ResizeTransform.apply_image takes float images "
                            f"(got {img.dtype}): convert to float32 first")
        return resize_bilinear(img, self.new_h, self.new_w)


class ResizeShortestEdge:
    """Resize the shortest edge to a target chosen from
    ``short_edge_length``, with the longest edge capped at ``max_size``."""

    def __init__(self, short_edge_length, max_size: int = 1333):
        if isinstance(short_edge_length, int):
            short_edge_length = (short_edge_length,)
        self.short_edge_length = tuple(short_edge_length)
        self.max_size = max_size

    @staticmethod
    def get_output_shape(h: int, w: int, size: int, max_size: int) -> Tuple[int, int]:
        scale = size / min(h, w)
        if h < w:
            new_h, new_w = size, scale * w
        else:
            new_h, new_w = scale * h, size
        if max(new_h, new_w) > max_size:
            s = max_size / max(new_h, new_w)
            new_h *= s
            new_w *= s
        return int(new_h + 0.5), int(new_w + 0.5)

    def get_transform(self, image: np.ndarray, rng: np.random.RandomState) -> ResizeTransform:
        h, w = image.shape[:2]
        size = int(rng.choice(self.short_edge_length))
        if size == 0:         # no test-time resize
            return ResizeTransform(h, w, h, w)
        new_h, new_w = self.get_output_shape(h, w, size, self.max_size)
        return ResizeTransform(h, w, new_h, new_w)


def pick_bucket(h: int, w: int, buckets: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """Smallest bucket that fits (h, w); the largest-area one if none does."""
    best = None
    best_area = None
    for bh, bw in buckets:
        if bh >= h and bw >= w:
            area = bh * bw
            if best_area is None or area < best_area:
                best, best_area = (bh, bw), area
    if best is None:
        best = max(buckets, key=lambda b: b[0] * b[1])
    return best
