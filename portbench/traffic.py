"""The benchmark's one traffic generator: synthetic files drawn from a seed.

``write_train_set`` writes a training set for ``DatasetMapper`` (JPEG scenes,
an instances JSON with RLE and polygon masks, a stuff map per image) at the
paths a workload file names. Every seed gets the same image sizes and the
same instance counts, in another order (the workload's ``sizes`` and the
counts drawn from its own ``count_seed``), so two seeds ask the same work of
the program; the pixels, the shapes and the classes come from the seed.

Copied from the port's ``testing.scene`` and
``testing.write_synthetic_u2seg_train`` (which ``chip_smoke.py`` uses), with
files written by Pillow and RLE encoded here, so that nothing of the port is
imported.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


def _ellipse(h: int, w: int, cx: float, cy: float, ax: float, ay: float,
             th: float) -> tuple:
    """(rows, cols, inside) of the ellipse's bounding square cut to the
    image: only there can a pixel lie inside it."""
    r = max(ax, ay)
    y0, y1 = max(0, int(cy - r)), min(h, int(cy + r) + 2)
    x0, x1 = max(0, int(cx - r)), min(w, int(cx + r) + 2)
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    dy, dx = yy - cy, xx - cx
    u = (dx * np.cos(th) + dy * np.sin(th)) / ax
    v = (-dx * np.sin(th) + dy * np.cos(th)) / ay
    return slice(y0, y1), slice(x0, x1), u * u + v * v <= 1.0


def scene(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """An RGB scene (f32 in [0, 255]): a smooth background and 10-25 solid
    ellipses."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for ch in range(3):
        a, b_, c_ = rng.random(3)
        img[..., ch] = 60 + 80 * (a * yy / h + b_ * xx / w + c_) / 3
    for _ in range(int(rng.integers(10, 25))):
        cy, cx = rng.random() * h, rng.random() * w
        ay, ax = int(rng.integers(18, 90)), int(rng.integers(18, 90))
        rows, cols, inside = _ellipse(h, w, cx, cy, ax, ay, rng.random() * np.pi)
        img[rows, cols][inside] = rng.random(3) * 255
    return img.clip(0, 255)


def counts_to_string(counts: Sequence[int]) -> str:
    """COCO's compressed RLE string of run lengths."""
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
    return s.decode("ascii")


def rle_encode(mask: np.ndarray) -> dict:
    """Binary (H, W) mask -> COCO compressed RLE (column-major runs)."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).ravel(order="F")
    change = np.nonzero(np.diff(flat))[0] + 1
    counts = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts_to_string(counts)}


def star_polygon(rng: np.random.Generator, cx: float, cy: float, r: float) -> List[float]:
    """A non-convex polygon of 12-40 vertices around (cx, cy), flattened."""
    n = int(rng.integers(12, 41))
    th = np.sort(rng.random(n)) * 2 * np.pi
    rad = r * (0.35 + 0.65 * rng.random(n))
    return np.stack([cx + rad * np.cos(th), cy + rad * np.sin(th)], 1).reshape(-1).tolist()


def polygon_mask(polys: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    from PIL import Image, ImageDraw

    canvas = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(canvas)
    for p in polys:
        draw.polygon([(p[i], p[i + 1]) for i in range(0, len(p), 2)], fill=1)
    return np.asarray(canvas, bool)


def ellipse_mask(rng: np.random.Generator, h: int, w: int, cx: float, cy: float,
                 r: float) -> np.ndarray:
    ay, ax = r * (0.5 + 0.5 * rng.random()), r * (0.5 + 0.5 * rng.random())
    rows, cols, inside = _ellipse(h, w, cx, cy, ax, ay, rng.random() * np.pi)
    mask = np.zeros((h, w), bool)
    mask[rows, cols] = inside
    return mask


def instance_counts(spec: dict, n: int) -> List[int]:
    """``n`` instance counts in [min, max] with the given mean, drawn from
    the workload's own ``count_seed`` (the same list for every run seed):
    1 + a negative binomial of shape 2, cut at ``max``."""
    rng = np.random.default_rng(spec["count_seed"])
    lo, hi, mean = spec["min"], spec["max"], spec["mean"]
    p = 2.0 / (2.0 + (mean - lo))
    return [int(min(hi, lo + rng.negative_binomial(2, p))) for _ in range(n)]


def image_sizes(spec: dict) -> List[Tuple[int, int]]:
    """(h, w) of every image: each short side of the list, landscape and
    portrait, at the long side."""
    long = spec["long_side"]
    return [s for short in spec["short_sides"] for s in ((short, long), (long, short))]


def write_train_set(root: str, traffic: dict, seed: int) -> Dict[str, object]:
    """Write the training set a workload's ``data`` describes under ``root``;
    returns where it went and what it holds."""
    spec = traffic["data"]
    rng = np.random.default_rng([seed, 1])
    sizes = image_sizes(spec["images"])
    counts = instance_counts(spec["instances"], len(sizes))
    order = rng.permutation(len(sizes))
    paths = {k: os.path.join(root, v) for k, v in spec["paths"].items()}
    for key in ("images", "sem_seg"):
        os.makedirs(paths[key], exist_ok=True)
    os.makedirs(os.path.dirname(paths["instances"]), exist_ok=True)
    cats: List[int] = spec["thing_ids"] if "thing_ids" in spec else list(
        range(1, spec["num_things"] + 1))
    stuff_hi = spec["num_stuff"]
    poly_share = spec["instances"]["polygon_share"]
    from PIL import Image

    images, anns = [], []
    for k in order.tolist():
        h, w = sizes[k]
        image_id = 1000 + 13 * len(images)
        name = f"{image_id:012d}"
        img = scene(rng, h, w)
        sem = np.zeros((h, w), np.uint8)
        bands = int(rng.integers(2, 5))
        cuts = np.linspace(0, h, bands + 1).astype(int)
        for j in range(bands):
            sem[cuts[j]:cuts[j + 1]] = rng.integers(1, stuff_hi + 1)
        placed = 0
        while placed < counts[k]:
            cx, cy = rng.random() * w, rng.random() * h
            r = (0.04 + 0.2 * rng.random()) * min(h, w)
            if rng.random() >= poly_share:
                mask = ellipse_mask(rng, h, w, cx, cy, r)
                segm = rle_encode(mask) if mask.any() else None
            else:
                segm = [star_polygon(rng, cx, cy, r)]
                if rng.random() < 0.2:
                    segm.append(star_polygon(rng, cx + r, cy, 0.5 * r))
                mask = polygon_mask(segm, h, w)
            if segm is None or not mask.any():
                continue
            ys, xs = np.nonzero(mask)
            x0, y0 = float(xs.min()), float(ys.min())
            img[mask] = rng.random(3) * 255
            sem[mask] = 0
            anns.append({"id": len(anns) + 1, "image_id": image_id,
                         "category_id": int(cats[int(rng.integers(len(cats)))]),
                         "bbox": [x0, y0, float(xs.max() + 1) - x0, float(ys.max() + 1) - y0],
                         "area": float(mask.sum()), "iscrowd": 0, "segmentation": segm})
            placed += 1
        if k == 0:                     # one crowd region, on the same image every seed
            mask = ellipse_mask(rng, h, w, w / 2, h / 2, min(h, w) / 6)
            ys, xs = np.nonzero(mask)
            anns.append({"id": len(anns) + 1, "image_id": image_id,
                         "category_id": int(cats[0]),
                         "bbox": [float(xs.min()), float(ys.min()),
                                  float(xs.max() - xs.min() + 1),
                                  float(ys.max() - ys.min() + 1)],
                         "area": float(mask.sum()), "iscrowd": 1,
                         "segmentation": rle_encode(mask)})
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(paths["images"], name + ".jpg"), format="JPEG")
        Image.fromarray(sem).save(os.path.join(paths["sem_seg"], name + ".png"), format="PNG")
        images.append({"id": image_id, "file_name": name + ".jpg", "height": h, "width": w})
    categories = [{"id": int(c), "name": f"thing_{c}", "supercategory": "thing"} for c in cats]
    with open(paths["instances"], "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": categories}, f)
    return {"paths": paths, "images": len(images), "instances": len(anns)}
