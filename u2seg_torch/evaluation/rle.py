"""COCO run-length-encoding codec in numpy (counterpart of
``u2seg_tpu/evaluation/rle.py``): the part the predictor's records need.

The wire format is pycocotools': column-major (Fortran) run lengths that
start with a background run, compressed to the 6-bit delta string of
``rleToString``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

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
