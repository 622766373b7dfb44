"""The port's mask operations (``u2seg_torch/evaluation/rle.py``: merge, iou,
to_bbox, frPyObjects, polygon rasterisation) and COCO index
(``evaluation/coco_api.py``) against the JAX package's, on numpy-seeded
masks, polygons and annotation sets. RLEs, boxes, masks and index answers
are compared exactly; IoU matrices at rtol 1e-12 (the JAX package may take
its C++ matcher, the port always takes numpy).
"""
import copy

import numpy as np
import pytest

from u2seg_tpu.evaluation import coco_api as jcoco_api
from u2seg_tpu.evaluation import rle as jrle
from u2seg_torch.evaluation import coco_api, rle


def masks(seed, n, h=23, w=31, p=0.5):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        m = np.zeros((h, w), np.uint8)
        y0, x0 = rng.randint(0, h - 3), rng.randint(0, w - 3)
        m[y0:y0 + rng.randint(2, h), x0:x0 + rng.randint(2, w)] = 1
        m &= (rng.rand(h, w) < p + 0.4).astype(np.uint8)
        out.append(m)
    return out


def polygon(rng, h, w, k):
    """A star-shaped polygon of k vertices, partly outside the image."""
    cy, cx = rng.rand() * h, rng.rand() * w
    ang = np.sort(rng.rand(k)) * 2 * np.pi
    rad = rng.rand(k) * max(h, w) * 0.6 + 1
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1).ravel().tolist()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("intersect", [False, True])
def test_merge_matches_jax(seed, intersect):
    rles = [rle.encode(m) for m in masks(seed, 4)]
    got = rle.merge(rles, intersect=intersect)
    assert got == jrle.merge(rles, intersect=intersect)
    ref = np.logical_and.reduce if intersect else np.logical_or.reduce
    np.testing.assert_array_equal(rle.decode(got), ref([rle.decode(r) for r in rles]))
    assert rle.merge([]) == jrle.merge([])


@pytest.mark.parametrize("seed", range(4))
def test_iou_matches_jax(seed):
    dt = [rle.encode(m) for m in masks(seed, 5)]
    gt = [rle.encode(m) for m in masks(seed + 10, 3)] + [rle.encode(np.zeros((23, 31), np.uint8))]
    crowd = [0, 1, 0, 1]
    got = rle.iou(dt, gt, crowd)
    np.testing.assert_allclose(got, jrle.iou(dt, gt, crowd), rtol=1e-12, atol=0)
    assert got.shape == (5, 4) and (got[:, 3] == 0).all()
    assert rle.iou([], gt, crowd).shape == (0, 4)


@pytest.mark.parametrize("seed", range(3))
def test_to_bbox_matches_jax(seed):
    for m in masks(seed, 3) + [np.zeros((5, 6), np.uint8)]:
        r = rle.encode(m)
        np.testing.assert_array_equal(rle.to_bbox(r), jrle.to_bbox(r))


@pytest.mark.parametrize("seed", range(6))
def test_polygon_rasterisation_matches_jax(seed):
    rng = np.random.RandomState(seed)
    h, w = rng.randint(8, 60, 2)
    polys = [polygon(rng, h, w, k) for k in (3, 5, 9)]
    got = rle.frPyObjects(polys, h, w)
    assert got == jrle.frPyObjects(polys, h, w)
    for p in polys:
        arr = np.asarray(p, np.float64)
        assert rle._poly_to_rle(arr, h, w) == jrle._poly_to_rle(arr, h, w)
        assert rle.frPyObjects(p, h, w) == jrle.frPyObjects(p, h, w)


def test_frpyobjects_takes_rle_dicts_like_jax():
    m = masks(7, 1)[0]
    enc = rle.encode(m)
    counts = rle.string_to_counts(enc["counts"])
    unc = {"size": [23, 31], "counts": counts}
    assert rle.frPyObjects(unc, 23, 31) == jrle.frPyObjects(unc, 23, 31) == enc
    assert rle.frPyObjects(enc, 23, 31) is enc
    with pytest.raises(TypeError):
        rle.frPyObjects(3.0, 4, 4)


@pytest.fixture
def gt_dict():
    rng = np.random.RandomState(0)
    images = [{"id": i, "height": 40, "width": 50} for i in (3, 1, 2)]
    anns, k = [], 1
    for img in images:
        for _ in range(rng.randint(1, 4)):
            x, y = rng.randint(0, 30, 2)
            w, h = rng.randint(4, 20, 2)
            seg = ([[x, y, x + w, y, x + w, y + h, x, y + h]] if k % 3 else
                   {"size": [40, 50], "counts": rle.string_to_counts(
                       rle.encode(masks(k, 1, 40, 50)[0])["counts"])})
            anns.append({"id": k, "image_id": img["id"], "category_id": int(rng.choice([5, 7, 9])),
                         "bbox": [float(x), float(y), float(w), float(h)],
                         "area": float(w * h), "iscrowd": int(k % 4 == 0),
                         "segmentation": seg})
            k += 1
    cats = [{"id": c, "name": f"c{c}", "supercategory": "s" if c < 9 else "t"}
            for c in (5, 7, 9)]
    return {"images": images, "annotations": anns, "categories": cats}


def test_coco_index_queries_match_jax(gt_dict):
    a, b = coco_api.COCO(copy.deepcopy(gt_dict)), jcoco_api.COCO(copy.deepcopy(gt_dict))
    for kw in ({}, {"imgIds": [1, 2]}, {"catIds": 7}, {"areaRng": [0, 100]},
               {"imgIds": 3, "catIds": [5, 9], "iscrowd": 0}, {"iscrowd": 1}):
        assert a.getAnnIds(**kw) == b.getAnnIds(**kw), kw
    for kw in ({}, {"catNms": ["c5"]}, {"supNms": "t"}, {"catIds": [7, 9]}):
        assert a.getCatIds(**kw) == b.getCatIds(**kw), kw
    for kw in ({}, {"imgIds": [1, 3]}, {"catIds": [5]}, {"imgIds": [1, 2, 3], "catIds": [7, 9]}):
        assert sorted(a.getImgIds(**kw)) == sorted(b.getImgIds(**kw)), kw
    ids = a.getAnnIds()
    assert a.loadAnns(ids) == b.loadAnns(ids)
    assert a.loadCats(7) == b.loadCats(7) and a.loadImgs([1, 2]) == b.loadImgs([1, 2])
    for ann in a.loadAnns(ids):
        assert a.annToRLE(ann) == b.annToRLE(ann)
        np.testing.assert_array_equal(a.annToMask(ann), b.annToMask(ann))


def test_load_res_matches_jax(gt_dict):
    a, b = coco_api.COCO(copy.deepcopy(gt_dict)), jcoco_api.COCO(copy.deepcopy(gt_dict))
    rng = np.random.RandomState(1)
    boxes = [{"image_id": int(rng.choice([1, 2, 3])), "category_id": 5,
              "bbox": [float(v) for v in rng.rand(4) * 20 + 1], "score": float(rng.rand())}
             for _ in range(6)]
    segs = [{"image_id": 1, "category_id": 7, "score": 0.5,
             "segmentation": rle.encode(m)} for m in masks(2, 3, 40, 50)]
    for res in (boxes, segs, []):
        ra, rb = a.loadRes(copy.deepcopy(res)), b.loadRes(copy.deepcopy(res))
        assert ra.dataset == rb.dataset
        assert ra.getAnnIds() == rb.getAnnIds()
        for ann in ra.loadAnns(ra.getAnnIds()):
            assert ra.annToRLE(ann) == rb.annToRLE(ann)
