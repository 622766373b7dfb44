"""OpenCV's affine primitives without OpenCV.

The JAX package warps with ``cv2.warpAffine``, ``cv2.getRotationMatrix2D``,
``cv2.transform`` and ``cv2.blur`` (its rotation and extent transforms and
FixMatch's RandAugmentMC). The machine with the card has no OpenCV, so the
port computes what OpenCV 5.0 computes, with torch CPU ops on host arrays
(they leave the GIL to the loader's other threads):

- ``get_rotation_matrix_2d``: OpenCV's double formula; the centre is a
  ``Point2f``, so its coordinates are rounded to f32 first.
- ``transform``: ``cv2.transform`` of (N, 1, 2) f64 points by a 2x3 matrix:
  ``fma(x, m00, y * m01) + m02`` per row, or ``fma(x, m00, m02)`` /
  ``fma(y, m11, m12)`` when the off-diagonal entries are at most
  ``DBL_EPSILON`` (OpenCV's diagonal path). The fused multiply-adds are
  exact (``_fma64``).
- ``warp_affine``: ``cv2.warpAffine`` with ``BORDER_CONSTANT``, linear or
  nearest, uint8 or f32, 1-4 channels. The matrix is inverted in double as
  OpenCV does (``invert_affine``) and rounded to f32; each destination
  pixel's source point is computed in f32 in one of two orders, split
  where OpenCV's vector loop ends and its scalar loop takes the remainder
  of a row (``VECTOR_PIXELS``):
  vector part ``sx = fma(m00, x, f32(y * m01) + m02)``, scalar remainder
  ``sx = fma(x, m00, f32(y * m01)) + m02`` (the same for ``sy``).
  Linear: cell ``floor``, weights ``sx - floor(sx)`` in f32, the four taps
  (a tap outside the image reads the border value) blended as
  ``v0 = fma(fx, p01 - p00, p00)``, ``v1 = fma(fx, p11 - p10, p10)``,
  ``v = fma(fy, v1 - v0, v0)`` in f32; uint8 rounds half to even and
  saturates. Nearest: the tap at ``rint(sx), rint(sy)``.
  This rule reproduces OpenCV 5.0.0's x86 build, whose widest dispatch
  (AVX-512: 16 f32 lanes per vector) decides the split; the 4.x fixed-point
  rule (1/32-pixel tables, 15-bit weights) is gone in 5.0.
- ``blur3x3``: ``cv2.blur(x, (3, 3))`` on uint8 with ``BORDER_REFLECT_101``:
  the 3x3 integer sum, ``round(sum / 9)``.

``tests/test_torch_warp.py`` holds each against ``cv2`` bit for bit (uint8)
and to f32 rounding.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

# the pixels of one row that OpenCV 5.0's vector loop covers come in
# multiples of this; the rest of the row takes its scalar loop
VECTOR_PIXELS = 16
_DBL_EPSILON = 2.220446049250313e-16


# ---------------------------------------------------------------------------
# Exact fused multiply-adds
# ---------------------------------------------------------------------------

def _two_prod(a: np.ndarray, b: np.ndarray):
    """``a * b = p + e`` exactly (Dekker's product with Veltkamp's split)."""
    p = a * b
    split = 134217729.0                                     # 2^27 + 1

    def halves(x):
        c = split * x
        hi = c - (c - x)
        return hi, x - hi

    ah, al = halves(a)
    bh, bl = halves(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma64(a, b, c) -> np.ndarray:
    """``round(a * b + c)`` in f64 (numpy): the product split exactly, the
    sum of its two parts and ``c`` rounded once for all practical inputs."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    p, e = _two_prod(a, b)
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)                           # p + c = s + t exactly
    return s + (t + e)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``round_f32(a * b + c)`` of f32 tensors, rounded once: the product is
    exact in f64, the sum rounded to odd in f64 (the error of the f64 sum
    pushes an even result to its odd neighbour), then to f32 — rounding to
    odd with 53 >= 24 + 2 bits makes the second rounding exact."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(t > 0, torch.full_like(s, math.inf), torch.full_like(s, -math.inf))
    s = torch.where((t != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


# ---------------------------------------------------------------------------
# Matrices and points
# ---------------------------------------------------------------------------

def get_rotation_matrix_2d(center: Sequence[float], angle: float,
                           scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: (2, 3) f64, angle
    in degrees counter-clockwise."""
    cx, cy = (float(np.float32(v)) for v in center)
    a = float(angle) * (math.pi / 180.0)
    alpha = math.cos(a) * scale
    beta = math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def transform(coords: np.ndarray, m: np.ndarray) -> np.ndarray:
    """``cv2.transform(coords, m)`` of (N, 1, 2) f64 points by a (2, 3)
    matrix -> (N, 1, 2) f64."""
    pts = np.asarray(coords, np.float64).reshape(-1, 2)
    m = np.asarray(m, np.float64)
    x, y = pts[:, 0], pts[:, 1]
    if abs(m[0, 1]) <= _DBL_EPSILON and abs(m[1, 0]) <= _DBL_EPSILON:
        out = np.stack([_fma64(x, m[0, 0], m[0, 2]), _fma64(y, m[1, 1], m[1, 2])], -1)
    else:
        out = np.stack([_fma64(x, m[0, 0], y * m[0, 1]) + m[0, 2],
                        _fma64(x, m[1, 0], y * m[1, 1]) + m[1, 2]], -1)
    return out.reshape(-1, 1, 2)


def invert_affine(m: np.ndarray) -> np.ndarray:
    """The inverse map ``cv2.warpAffine`` samples with (its own double
    formula, in its order)."""
    m00, m01, m02, m10, m11, m12 = (float(v) for v in np.asarray(m, np.float64).reshape(-1))
    d = m00 * m11 - m01 * m10
    d = 1.0 / d if d != 0 else 0.0
    a00, a11 = m11 * d, m00 * d
    a01, a10 = m01 * -d, m10 * -d
    b0 = -a00 * m02 - a01 * m12
    b1 = -a10 * m02 - a11 * m12
    return np.array([[a00, a01, b0], [a10, a11, b1]], np.float64)


# ---------------------------------------------------------------------------
# The warp
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _source_points_of(inv: bytes, width: int, height: int):
    return _source_points(np.frombuffer(inv, np.float64).reshape(2, 3), width, height)


def _source_points(inv: np.ndarray, width: int, height: int):
    """Each destination pixel's source point, (H, W) f32 each, in OpenCV's
    two orders (see the module doc). ``_source_points_of`` keeps the last
    few, so an image's instance masks reuse the image's."""
    m = torch.from_numpy(inv.astype(np.float32))
    x = torch.arange(width, dtype=torch.float32)[None, :].expand(height, width)
    y = torch.arange(height, dtype=torch.float32)[:, None]
    split = width // VECTOR_PIXELS * VECTOR_PIXELS
    out = []
    for r in range(2):
        a, b, c = m[r, 0], m[r, 1], m[r, 2]
        yb = y * b                                              # f32 product
        vec = _fma32(a.expand(height, width), x, (yb + c).expand(height, width))
        if split < width:
            xs = x[:, split:]
            tail = _fma32(xs, a.expand_as(xs), yb.expand_as(xs)) + c
            vec = torch.cat([vec[:, :split], tail], dim=1)
        out.append(vec)
    return out


def _border(value, channels: int, dtype: torch.dtype) -> torch.Tensor:
    vals = ([value] * channels if np.isscalar(value)
            else list(value)[:channels] + [0] * max(0, channels - len(value)))
    t = torch.tensor(vals, dtype=torch.float64)
    if dtype == torch.uint8:
        t = torch.round(t).clamp(0, 255)                     # saturate_cast<uchar>
    return t.to(dtype)


def warp_affine(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int],
                interp: str = "linear",
                border_value: Union[float, Sequence[float]] = 0) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, flags, BORDER_CONSTANT, border_value)``
    of an (H, W) or (H, W, C) image: ``dsize`` is (width, height); ``interp``
    ``"linear"`` (uint8 or f32 images) or ``"nearest"`` (any dtype); a
    scalar ``border_value`` fills every channel, a sequence one value per
    channel. An (H, W, 1) image comes back (H, W), as from OpenCV, and an
    empty ``dsize`` (a side <= 0) means the input's size, as in OpenCV."""
    if interp not in ("linear", "nearest"):
        raise ValueError(f"interp must be 'linear' or 'nearest' (got {interp!r})")
    arr = np.ascontiguousarray(img)
    if interp == "linear" and arr.dtype not in (np.uint8, np.float32):
        raise TypeError(f"linear warp takes uint8 or float32 images (got {arr.dtype})")
    width, height = int(dsize[0]), int(dsize[1])
    if width <= 0 or height <= 0:
        height, width = arr.shape[:2]
    src = torch.from_numpy(arr)
    squeeze = src.dim() == 2 or src.shape[2] == 1
    if src.dim() == 2:
        src = src[..., None]
    h, w, ch = src.shape
    # one ring of the border value around the image: a tap outside the image
    # clamps into the ring and reads the border value
    padded = _border(border_value, ch, src.dtype).expand(h + 2, w + 2, ch).clone()
    padded[1:-1, 1:-1] = src
    flat = padded.reshape(-1, ch)

    def tap(iy, ix):
        iy = (iy + 1).clamp_(0, h + 1)
        ix = (ix + 1).clamp_(0, w + 1)
        return flat.index_select(0, (iy * (w + 2) + ix).reshape(-1)).reshape(height, width, ch)

    sx, sy = _source_points_of(invert_affine(m).tobytes(), width, height)
    if interp == "nearest":
        out = tap(torch.round(sy).long(), torch.round(sx).long())
    else:
        fx0, fy0 = torch.floor(sx), torch.floor(sy)
        ix, iy = fx0.long(), fy0.long()
        fx, fy = (sx - fx0)[..., None], (sy - fy0)[..., None]         # f32, (H, W, 1)
        if arr.dtype == np.uint8:
            # the uint8 taps' fx * (p01 - p00) + p00 is exact in f64 (24 + 9
            # bits), so one f64 sum rounded to f32 is the f32 FMA
            p00, p01 = tap(iy, ix).double(), tap(iy, ix + 1).double()
            p10, p11 = tap(iy + 1, ix).double(), tap(iy + 1, ix + 1).double()
            fx64 = fx.double()
            v0 = (fx64 * (p01 - p00) + p00).float()
            v1 = (fx64 * (p11 - p10) + p10).float()
            out = _round_blend_u8(fy, v1 - v0, v0)
        else:
            p00, p01 = tap(iy, ix).float(), tap(iy, ix + 1).float()
            p10, p11 = tap(iy + 1, ix).float(), tap(iy + 1, ix + 1).float()
            fx = fx.expand(height, width, ch)
            v0 = _fma32(fx, p01 - p00, p00)
            v1 = _fma32(fx, p11 - p10, p10)
            out = _fma32(fy.expand(height, width, ch), v1 - v0, v0)
    out = out.numpy()
    return out[..., 0] if squeeze else out


def _round_blend_u8(fy: torch.Tensor, d: torch.Tensor, v0: torch.Tensor) -> torch.Tensor:
    """``saturate_u8(rint(fma_f32(fy, d, v0)))`` with few exact FMAs. The f64
    sum rounded to f32 differs from the f32 FMA by at most one f32 ulp, and
    only where the f64 sum is an f32 midpoint; the rounded integers can then
    differ only within an ulp of k + 0.5 (< 2^-15 for values below 256), so
    those few pixels are recomputed exactly."""
    g = (fy.double() * d.double() + v0.double()).float()
    near = (g - torch.floor(g) - 0.5).abs() <= 2.0 ** -15
    if bool(near.any()):
        g[near] = _fma32(fy.expand_as(d)[near], d[near], v0[near])
    return torch.round(g).clamp_(0, 255).to(torch.uint8)


def blur3x3(img: np.ndarray) -> np.ndarray:
    """``cv2.blur(img, (3, 3))`` of a uint8 (H, W[, C]) image (border
    ``BORDER_REFLECT_101``): ``round(sum of the 3x3 window / 9)``."""
    if img.dtype != np.uint8:
        raise TypeError(f"blur3x3 takes uint8 images (got {img.dtype})")
    src = torch.from_numpy(np.ascontiguousarray(img)).to(torch.int32)
    h, w = src.shape[:2]

    def neighbours(n: int):
        i = torch.arange(n)
        if n == 1:
            return [i, i, i]
        lo = torch.where(i == 0, torch.ones_like(i), i - 1)
        hi = torch.where(i == n - 1, torch.full_like(i, n - 2), i + 1)
        return [lo, i, hi]

    rows = sum(src.index_select(0, i) for i in neighbours(h))
    s = sum(rows.index_select(1, i) for i in neighbours(w))
    return torch.div(2 * s + 9, 18, rounding_mode="floor").to(torch.uint8).numpy()
