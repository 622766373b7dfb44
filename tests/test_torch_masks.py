"""The port's mask utilities (``u2seg_torch/structures/masks.py``) against the
JAX package's (``u2seg_tpu/structures/masks.py``), on seeded inputs.

``polygons_to_bitmask``: the JAX function calls ``cv2.fillPoly``; the port
rasterises in numpy. Polygons whose vertices lie inside the image are held
bit for bit (convex, concave, sub-pixel, several per object, 1-pixel
images). Polygons that cross the border differ on a few pixels near it:
OpenCV clips such edges by rules the port reproduces only in part. The
share of differing pixels is held below ``BORDER_SHARE`` of the mask area
for star polygons centred near a border (measured: 0.7e-4 to 1.3e-4 over
three seeds of 200 polygons each) and below ``COCO_SHARE`` for polygons
whose points lie in [0, W] x [0, H] as COCO's do, so that some vertices
round to one past the last pixel (measured: 0.6e-5 to 1.0e-5).
"""
import numpy as np
import pytest
import torch

from u2seg_tpu.structures import masks as jmasks
from u2seg_torch.structures import masks
from u2seg_torch.testing import _star_polygon

torch.set_num_threads(1)

BORDER_SHARE = 2.5e-4
COCO_SHARE = 2.5e-5
SIZES = [(480, 640), (427, 640), (640, 480), (500, 375)]


def _inside(p: np.ndarray, h: int, w: int) -> np.ndarray:
    """Clip a flat polygon so that round(p - 0.5) lies inside the image."""
    q = p.reshape(-1, 2).copy()
    q[:, 0] = q[:, 0].clip(0.5, w - 0.6)
    q[:, 1] = q[:, 1].clip(0.5, h - 0.6)
    return q.reshape(-1)


def _polygons(kind: str, rng, h: int, w: int):
    if kind == "convex":
        n = rng.randint(3, 41)
        th = np.sort(rng.rand(n)) * 2 * np.pi
        r = (0.1 + 0.4 * rng.rand()) * min(h, w)
        cx, cy = w * (0.2 + 0.6 * rng.rand()), h * (0.2 + 0.6 * rng.rand())
        return [_inside(np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], 1).reshape(-1), h, w)]
    if kind == "concave":
        return [_inside(_star_polygon(rng, rng.rand() * w, rng.rand() * h,
                                      (0.05 + 0.3 * rng.rand()) * min(h, w)), h, w)]
    if kind == "random":                   # self-intersecting vertex soup
        n = rng.randint(3, 20)
        return [_inside(np.stack([rng.rand(n) * w, rng.rand(n) * h], 1).reshape(-1), h, w)]
    if kind == "subpixel":
        n = rng.randint(3, 8)
        cx, cy = rng.rand() * (w - 3) + 1, rng.rand() * (h - 3) + 1
        return [_inside(np.stack([cx + rng.rand(n) * 2, cy + rng.rand(n) * 2], 1).reshape(-1), h, w)]
    if kind == "several":                  # one object of 2-4 overlapping polygons
        return [_inside(_star_polygon(rng, rng.rand() * w, rng.rand() * h,
                                      (0.05 + 0.3 * rng.rand()) * min(h, w)), h, w)
                for _ in range(rng.randint(2, 5))]
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["convex", "concave", "random", "subpixel", "several"])
def test_polygons_inside_the_image_equal_cv2_bit_for_bit(kind):
    rng = np.random.RandomState(["convex", "concave", "random", "subpixel",
                                 "several"].index(kind))
    area = 0
    for i in range(60):
        h, w = (rng.randint(1, 90), rng.randint(1, 90)) if i % 3 else SIZES[i % 4]
        polys = _polygons(kind, rng, h, w)
        got = masks.polygons_to_bitmask(polys, h, w)
        ref = jmasks.polygons_to_bitmask(polys, h, w)
        assert got.dtype == ref.dtype == bool and got.shape == ref.shape == (h, w)
        assert np.array_equal(got, ref), (kind, i, h, w, int((got != ref).sum()))
        area += int(ref.sum())
    assert area > 100


def test_degenerate_polygons_match_cv2():
    for polys, h, w in [([], 5, 5), ([[1.0, 1.0, 3.0, 1.0]], 5, 5),
                        ([[1.0, 1.0, 3.0, 1.0, 5.0, 1.0]], 5, 5),        # horizontal
                        ([[2.0, 1.0, 2.0, 4.0, 2.0, 2.0]], 5, 5),        # vertical
                        ([[0.5, 0.5, 0.5, 0.5, 0.5, 0.5]], 1, 1),
                        ([[-9.0, -9.0, -5.0, -9.0, -7.0, -2.0]], 6, 6)]:  # off the image
        np.testing.assert_array_equal(masks.polygons_to_bitmask(polys, h, w),
                                      jmasks.polygons_to_bitmask(polys, h, w))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("coco", [False, True])
def test_polygons_crossing_the_border_differ_on_few_pixels(seed, coco):
    """Star polygons centred within their radius of each border in turn;
    with ``coco`` their points are clipped into [0, W] x [0, H]."""
    rng = np.random.RandomState(seed + 10 * coco)
    differ = area = exact = 0
    for i in range(200):
        h, w = SIZES[i % 4]
        r = (0.04 + 0.2 * rng.rand()) * min(h, w)
        side = i % 4
        near = lambda n: rng.rand() * r * 1.5 - 0.5 * r if rng.rand() < 0.5 else n - rng.rand() * r * 1.5 + 0.5 * r
        cx = near(w) if side >= 2 else rng.rand() * w
        cy = near(h) if side < 2 else rng.rand() * h
        poly = _star_polygon(rng, cx, cy, r)
        if coco:
            poly = poly.reshape(-1, 2).clip(0, [w, h]).reshape(-1)
        got = masks.polygons_to_bitmask([poly], h, w)
        ref = jmasks.polygons_to_bitmask([poly], h, w)
        d = int((got != ref).sum())
        differ += d
        area += int(ref.sum())
        exact += d == 0
    assert area > 100_000 and exact >= 120
    assert differ <= (COCO_SHARE if coco else BORDER_SHARE) * area, (differ, area)


def test_bitmasks_to_boxes_matches_jax():
    rng = np.random.RandomState(0)
    m = rng.rand(6, 23, 31) > 0.97
    m[2] = False                       # an empty mask gives a zero box
    m[3, 5:9, 0] = True
    np.testing.assert_array_equal(masks.bitmasks_to_boxes(m), jmasks.bitmasks_to_boxes(m))


def test_bitmask_areas_matches_jax():
    m = np.random.RandomState(1).rand(4, 9, 13) > 0.5
    got = masks.bitmask_areas(torch.from_numpy(m))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmasks.bitmask_areas(m)))


def test_crop_and_resize_matches_jax_roi_align():
    """The port pools (N, H, W) masks as NHWC maps of one channel with the
    JAX package's ``roi_align``. The JAX ``crop_and_resize`` hands that
    NHWC op an (N, 1, H, W) array and returns (N, S, W): its shape shows
    the fault (logged in ROADMAP.md); the port matches what it means."""
    from u2seg_tpu.ops.roi_align import roi_align as jroi_align

    rng = np.random.RandomState(2)
    n, h, w = 5, 40, 56
    m = (rng.rand(n, h, w) > 0.5).astype(np.float32)
    xy = rng.rand(n, 2) * [w - 10, h - 10]
    boxes = np.concatenate([xy, xy + rng.rand(n, 2) * 20 + 2], 1).astype(np.float32)
    idx = np.arange(n, dtype=np.int32)
    for s in (7, 28):
        ref = np.asarray(jroi_align(m[..., None], boxes, idx, s, 1.0, 0, True))[..., 0]
        got = masks.crop_and_resize(torch.from_numpy(m), torch.from_numpy(boxes), s)
        assert got.shape == (n, s, s) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
        assert np.asarray(jmasks.crop_and_resize(m, boxes, s)).shape == (n, s, w)
