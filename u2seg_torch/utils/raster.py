"""Raster primitives that reproduce OpenCV's drawing without OpenCV.

The JAX package's visualizer draws with ``cv2.rectangle`` (thickness 2),
``cv2.circle`` (filled, radius 3), ``cv2.line`` (thickness 1) and
``cv2.putText``; the machine with the card has no OpenCV. These functions are
transcriptions of OpenCV's ``imgproc/src/drawing.cpp`` for 8-connected lines
(``LINE_8``) on uint8 images, in its own fixed-point arithmetic
(``XY_SHIFT`` = 16), so that they equal ``cv2`` pixel for pixel:

- ``line``: ``cv2.line`` at thickness 1 -- Bresenham through ``LineIterator``
  (endpoints outside the image clipped by ``clipLine``, points ordered left to
  right);
- ``rectangle``: ``cv2.rectangle`` at thickness >= 2 -- ``PolyLine`` of four
  ``ThickLine`` segments, each a filled quadrangle (``FillConvexPoly`` with its
  outline drawn by ``Line2``) plus a round cap at its end (``Circle``);
- ``circle_filled``: ``cv2.circle`` with thickness -1 (``Circle``, filled).

Text has no twin without OpenCV: ``put_text`` draws a label from a 6 x 9 glyph
table kept here (deterministic on every machine), advancing by the widths of
OpenCV's Hershey simplex font at scale 0.5, so that a label lies inside the box
``cv2.getTextSize`` gives at the same origin (``text_box``).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _div(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _put(img: np.ndarray, x: int, y: int, color) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    """Pixels x1..x2 (inclusive) of row y, clipped to the image."""
    if 0 <= y < img.shape[0]:
        x1, x2 = max(x1, 0), min(x2, img.shape[1] - 1)
        if x1 <= x2:
            img[y, x1:x2 + 1] = color


def clip_line(width: int, height: int, p1: Tuple[int, int], p2: Tuple[int, int]):
    """``cv::clipLine`` on a ``width`` x ``height`` rectangle (integer or
    fixed-point coordinates): the clipped endpoints, or None when the segment
    misses it."""
    if width <= 0 or height <= 0:
        return None
    right, bottom = width - 1, height - 1
    (x1, y1), (x2, y2) = p1, p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def line(img: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int], color) -> None:
    """``cv2.line(img, p1, p2, color, 1)``: 8-connected Bresenham, points
    ordered left to right, endpoints clipped to the image."""
    h, w = img.shape[:2]
    p1, p2 = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        clipped = clip_line(w, h, p1, p2)
        if clipped is None:
            return
        p1, p2 = clipped
    (x, y), (x2, y2) = p1, p2
    dx, dy = x2 - x, y2 - y
    if dx < 0:
        dx, dy = -dx, -dy
        x, y = x2, y2
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
    for _ in range(dx + 1):
        img[y, x] = color
        step = err < 0
        err += minus + (plus if step else 0)
        if vert:
            y += sy
            x += step
        else:
            x += 1
            y += sy if step else 0


def _line2(img: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int], color) -> None:
    """OpenCV's ``Line2``: a line between fixed-point (``XY_SHIFT``) points."""
    h, w = img.shape[:2]
    clipped = clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        y_step = _div(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step = _div(dx << XY_SHIFT, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    _put(img, (x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT, color)
    n = ecount + 1
    if n <= 0:
        return
    k = np.arange(n, dtype=np.int64)
    if ax > ay:
        xs = (x1 >> XY_SHIFT) + k
        ys = (y1 + k * y_step) >> XY_SHIFT
    else:
        xs = (x1 + k * x_step) >> XY_SHIFT
        ys = (y1 >> XY_SHIFT) + k
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def fill_convex_poly(img: np.ndarray, pts: Sequence[Tuple[int, int]], color,
                     shift: int = 0) -> None:
    """OpenCV's ``FillConvexPoly`` for ``LINE_8``: the outline (``Line2``
    between fixed-point vertices, ``line`` when ``shift`` is 0), then the
    rows between the left and the right edge, stepped in fixed point."""
    h, w = img.shape[:2]
    v = [(int(x), int(y)) for x, y in pts]
    npts = len(v)
    delta = 1 << shift >> 1
    delta1 = delta2 = XY_ONE >> 1
    up = XY_SHIFT - shift
    p0 = (v[-1][0] << up, v[-1][1] << up)
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, (px, py) in enumerate(v):
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        p = (px << up, py << up)
        if shift == 0:
            line(img, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT),
                 (p[0] >> XY_SHIFT, p[1] >> XY_SHIFT), color)
        else:
            _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = npts
    # per edge: [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = (idx0 + di) % npts
                while True:
                    go = edges > 0
                    edges -= 1
                    if not go:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = v[idx0][0] << up, v[idx][0] << up
                        e[4] = ty
                        e[3] = _div((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx = (idx + di) % npts
        if edges < 0:
            break
        # rows y .. end - 1 step both edges without a change of edge
        end = min(edge[0][4], edge[1][4], ymax + 1)
        k = np.arange(end - y, dtype=np.int64)
        xa = edge[0][2] + k * edge[0][3]
        xb = edge[1][2] + k * edge[1][3]
        left, right = np.minimum(xa, xb), np.maximum(xa, xb)
        xx1 = (left + delta1) >> XY_SHIFT
        xx2 = (right + delta2) >> XY_SHIFT
        for row, a, b in zip(range(y, end), xx1.tolist(), xx2.tolist()):
            if row >= 0 and b >= 0 and a < w:
                img[row, max(a, 0):min(b, w - 1) + 1] = color
        edge[0][2] += (end - y) * edge[0][3]
        edge[1][2] += (end - y) * edge[1][3]
        y = end
        if y > ymax:
            break


def circle_filled(img: np.ndarray, center: Tuple[int, int], radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, -1)`` (OpenCV's ``Circle``
    with ``fill``): the midpoint circle's spans, clipped to the image."""
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        _hline(img, cy - dy, cx - dx, cx + dx, color)
        _hline(img, cy + dy, cx - dx, cx + dx, color)
        _hline(img, cy - dx, cx - dy, cx + dy, color)
        _hline(img, cy + dx, cx - dy, cx + dy, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def thick_line(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int], color,
               thickness: int, flags: int) -> None:
    """OpenCV's ``ThickLine`` for ``LINE_8`` at thickness >= 2 between integer
    points: the quadrangle around the segment and a round cap at ``p0``
    (``flags & 1``) and at ``p1`` (``flags & 2``). Equal to ``cv2.line`` for
    axis-parallel segments anywhere and for any segment whose endpoints lie
    in the image; a slanted segment that leaves the image is clipped by
    OpenCV 5 before it is widened, which this does not reproduce (the
    visualizer draws axis-parallel boxes only)."""
    p0 = (int(p0[0]) << XY_SHIFT, int(p0[1]) << XY_SHIFT)
    p1 = (int(p1[0]) << XY_SHIFT, int(p1[1]) << XY_SHIFT)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thick = thickness << (XY_SHIFT - 1)
    if abs(r) > 2.220446049250313e-16:
        r = (thick + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = round(dy * r), round(dx * r)
        fill_convex_poly(img, [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
                               (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)],
                         color, XY_SHIFT)
    for i, p in enumerate((p0, p1)):
        if flags & (i + 1):
            circle_filled(img, ((p[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                                (p[1] + (XY_ONE >> 1)) >> XY_SHIFT),
                          (thick + (XY_ONE >> 1)) >> XY_SHIFT, color)


def rectangle(img: np.ndarray, pt1: Tuple[int, int], pt2: Tuple[int, int], color,
              thickness: int = 2) -> None:
    """``cv2.rectangle(img, pt1, pt2, color, thickness)`` for thickness >= 2:
    a closed ``PolyLine`` of four thick segments, each capped at its end."""
    if thickness < 2:
        raise ValueError("rectangle reproduces cv2 for thickness >= 2 only")
    (x0, y0), (x1, y1) = (int(pt1[0]), int(pt1[1])), (int(pt2[0]), int(pt2[1]))
    v = [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
    p0 = v[-1]
    for p in v:
        thick_line(img, p0, p, color, thickness, 2)
        p0 = p


# ---------------------------------------------------------------------------
# Text: a glyph table at the metrics of Hershey simplex, scale 0.5
# ---------------------------------------------------------------------------

# Printable ASCII (32..126): advance in pixels and depth below the baseline
# of each character in OpenCV's FONT_HERSHEY_SIMPLEX at scale 0.5, thickness
# 1. ``cv2.getTextSize`` gives width = sum of advances + 1, height 14, and
# baseline = the largest depth of the string's characters.
_ADVANCE = (
    3, 3, 5, 10, 9, 11, 10, 3, 9, 9, 6, 9, 3, 7, 3, 7, 9, 9, 9, 9, 9, 9, 9, 9,
    9, 9, 3, 4, 7, 8, 7, 7, 12, 10, 10, 9, 10, 9, 8, 10, 10, 4, 9, 9, 8, 11, 10, 10,
    9, 10, 9, 9, 8, 10, 9, 11, 9, 9, 8, 4, 7, 4, 6, 11, 5, 8, 8, 8, 8, 8, 5, 8,
    9, 3, 3, 7, 3, 13, 9, 8, 8, 8, 5, 7, 5, 9, 8, 12, 8, 8, 7, 5, 3, 5, 8,
)
_DEPTH = (
    0, 0, 0, 0, 2, 1, 1, 0, 2, 2, 0, 0, 2, 0, 0, 2, 1, 0, 0, 1, 0, 1, 1, 0,
    1, 0, 0, 2, 0, 0, 0, 0, 2, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0, 1,
    0, 1, 0, 1, 0, 1, 0, 0, 0, 0, 0, 3, 2, 3, 0, 1, 0, 1, 1, 1, 1, 1, 0, 4,
    0, 0, 3, 0, 0, 0, 0, 1, 3, 3, 0, 1, 0, 1, 0, 0, 0, 3, 0, 3, 4, 3, 0,
)
TEXT_HEIGHT = 14
# One glyph per character: 9 rows of 6 pixels (two hex digits a row, the
# leftmost pixel the highest of 6 bits); row 6 sits on the baseline, rows 7-8
# are descenders.
_GLYPHS = (
    "000000000000000000", "001818181800180000", "001414140000000000", "14143e14143e141400", "1e323c1e06363c0800", "382a3c081e2a0e0000", "001c30183e2c3e0000", "0c0810000000000000",
    "040818181818080400", "10080c0c0c0c081000", "083c18240000000000", "0008083e0808000000", "0000000000000c0810", "0000003e0000000000", "000000000000180000", "020204040808101000",
    "1c36363636361c0000", "0c3c0c0c0c0c3f0000", "1c36060c18363e0000", "1c36061c06361c0000", "060e16363f06060000", "3e303c3606263c0000", "1c36303c36361c0000", "3e36060c0c18180000",
    "1c36361c36361c0000", "1c36361e06361c0000", "000000180000180000", "000000180000181020", "000c1830180c000000", "00003c003c00000000", "00180c060c18000000", "001c260c1800180000",
    "1c32262a2a27301c00", "003c1c143e36370000", "003c363c36363c0000", "001e363030361c0000", "003c363636363c0000", "003e303c30363e0000", "003e303c3030380000", "001c36303e361e0000",
    "0037363e3636370000", "003c181818183c0000", "001e0c0c2c2c380000", "003634383c363b0000", "0038303030363e0000", "002236363e2a2a0000", "00373a3a3636320000", "001c363636361c0000",
    "003c36363c30380000", "001c363636361c0600", "003c36363c363b0000", "001e323c0e263c0000", "003e1a1818183c0000", "0037363636361c0000", "003736141c1c080000", "002b2a2a3e1c140000",
    "00331e0c0c1e330000", "0033331e0c0c1e0000", "003e360c18363e0000", "1c1818181818181c00", "202010100808040400", "1c0c0c0c0c0c0c1c00", "081c36000000000000", "00000000000000003f",
    "180804000000000000", "00001c361e363f0000", "30303c3636363c0000", "00001c3630361c0000", "0e061e3636361f0000", "00001c363e301e0000", "0e183e1818183e0000", "00001b3636361e063c",
    "30303c363636360000", "0c003c0c0c0c3f0000", "0c003c0c0c0c0c0c38", "3030363c383c370000", "3c0c0c0c0c0c3f0000", "00003c3e2a2a2a0000", "00002c363636360000", "00001c3636361c0000",
    "00003c3636363c3038", "00001b3636361e060f", "0000371d18183c0000", "00001e381e073e0000", "18183e18181b0e0000", "0000363636361f0000", "000036361c1c080000", "00002b2a3e1e140000",
    "00003b1e0c1e370000", "0000373636141c1830", "00003e2c18363e0000", "060c0c180c0c0c0600", "000808080808080800", "3018180c1818183000", "00001a2c0000000000",
)
_BASELINE_ROW = 6


def _index(ch: str) -> int:
    c = ord(ch)
    return c - 32 if 32 <= c < 127 else ord("?") - 32


def text_size(text: str) -> Tuple[Tuple[int, int], int]:
    """``cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX, 0.5, 1)``: ((width,
    height), baseline)."""
    idx = [_index(c) for c in text]
    return ((sum(_ADVANCE[i] for i in idx) + 1, TEXT_HEIGHT),
            max((_DEPTH[i] for i in idx), default=0))


def text_box(text: str, org: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """Inclusive (x0, y0, x1, y1) of the box ``cv2.getTextSize`` gives for
    ``text`` at origin ``org`` (the bottom-left of its baseline)."""
    (tw, th), base = text_size(text)
    x, y = org
    return x, y - th, x + tw, y + base


def put_text(img: np.ndarray, text: str, org: Tuple[int, int], color) -> None:
    """Draw ``text`` with its baseline's left end at ``org``, glyph after
    glyph at the Hershey advances, clipped to ``text_box`` and the image."""
    x0, y0, x1, y1 = text_box(text, org)
    h, w = img.shape[:2]
    cx, by = org
    for ch in text:
        i = _index(ch)
        g = _GLYPHS[i]
        for r in range(9):
            bits = int(g[2 * r:2 * r + 2], 16)
            y = by - _BASELINE_ROW + r
            if bits == 0 or not (max(y0, 0) <= y <= min(y1, h - 1)):
                continue
            for col in range(6):
                x = cx + col
                if bits >> (5 - col) & 1 and max(x0, 0) <= x <= min(x1, w - 1):
                    img[y, x] = color
        cx += _ADVANCE[i]
