"""The port's COCOeval (``u2seg_torch/evaluation/coco_eval_core.py``, numpy
path only) against the JAX package's (which takes its C++ matcher where g++
built it) on random bbox, segm and keypoint sets: ``precision``, ``recall``,
``scores`` and ``stats`` at atol 1e-12. Then against the reference's own C++
COCOeval output (``tests/golden/fixtures/cocoeval_golden.npz``) at the atol
1e-6 of ``tests/golden/test_cocoeval_golden.py``.
"""
import copy
import json
import os

import numpy as np
import pytest

from u2seg_tpu.evaluation import coco_api as jcoco_api
from u2seg_tpu.evaluation import coco_eval_core as jcore
from u2seg_torch.evaluation import coco_api, coco_eval_core, rle

FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "fixtures",
                       "cocoeval_golden.npz")


def random_set(seed, kind, n_img=5, cats=(1, 2, 3)):
    """GT and detections over ``n_img`` 64x80 images; detections jitter the
    GT boxes (some far off), with score ties, crowd GT and empty images."""
    rng = np.random.RandomState(seed)
    h, w = 64, 80
    images = [{"id": i + 1, "height": h, "width": w} for i in range(n_img)]
    gts, dts = [], []
    for img in images[:-1]:                              # the last has no GT
        for _ in range(rng.randint(1, 6)):
            x, y = rng.rand(2) * [w - 20, h - 20]
            bw, bh = rng.rand(2) * [30, 30] + 4
            cat = int(rng.choice(cats))
            ann = {"id": len(gts) + 1, "image_id": img["id"], "category_id": cat,
                   "bbox": [x, y, bw, bh], "area": float(bw * bh * rng.choice([1, 0.3, 40])),
                   "iscrowd": int(rng.rand() < 0.15)}
            if kind == "segm":
                m = np.zeros((h, w), np.uint8)
                m[int(y):int(y + bh), int(x):int(x + bw)] = 1
                ann["segmentation"] = [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]]
                ann["area"] = float(m.sum())
            if kind == "keypoints":
                kp = np.zeros((17, 3))
                kp[:, 0] = x + rng.rand(17) * bw
                kp[:, 1] = y + rng.rand(17) * bh
                kp[:, 2] = (rng.rand(17) < 0.7) * 2
                ann["keypoints"] = kp.ravel().tolist()
                ann["num_keypoints"] = int((kp[:, 2] > 0).sum())
                ann["category_id"] = 1
            gts.append(ann)
            for _ in range(rng.randint(0, 3)):
                jit = rng.randn(4) * rng.choice([0.5, 3, 15])
                bb = [x + jit[0], y + jit[1], max(1, bw + jit[2]), max(1, bh + jit[3])]
                det = {"image_id": img["id"], "category_id": ann["category_id"],
                       "bbox": bb, "score": float(rng.choice([0.9, 0.5, rng.rand()]))}
                if kind == "segm":
                    m = np.zeros((h, w), np.uint8)
                    m[max(0, int(bb[1])):int(bb[1] + bb[3]), max(0, int(bb[0])):int(bb[0] + bb[2])] = 1
                    enc = rle.encode(m)
                    enc["counts"] = enc["counts"].decode("ascii")
                    det = {k: v for k, v in det.items() if k != "bbox"}
                    det["segmentation"] = enc
                if kind == "keypoints":
                    kp = np.asarray(ann["keypoints"]).reshape(17, 3).copy()
                    kp[:, :2] += rng.randn(17, 2) * rng.choice([0.5, 4])
                    kp[:, 2] = 1
                    det["keypoints"] = kp.ravel().tolist()
                dts.append(det)
    for _ in range(3):                                   # false positives
        bb = (rng.rand(4) * [w, h, 20, 20] + [0, 0, 2, 2]).tolist()
        det = {"image_id": int(rng.randint(1, n_img + 1)), "category_id": int(rng.choice(cats)),
               "bbox": bb, "score": float(rng.rand())}
        if kind == "segm":
            m = np.zeros((h, w), np.uint8)
            m[int(bb[1]):int(bb[1] + bb[3]), int(bb[0]):int(bb[0] + bb[2])] = 1
            enc = rle.encode(m)
            enc["counts"] = enc["counts"].decode("ascii")
            det = {k: v for k, v in det.items() if k != "bbox"}
            det["segmentation"] = enc
        if kind == "keypoints":
            det["keypoints"] = (rng.rand(51) * 50).tolist()
            det["category_id"] = 1
        dts.append(det)
    cat_list = [{"id": 1, "name": "person"}] if kind == "keypoints" else \
        [{"id": c, "name": str(c)} for c in cats]
    return {"images": images, "annotations": gts, "categories": cat_list}, dts


def run(api, core, gt, dts, kind, max_dets=None):
    coco_gt = api.COCO(copy.deepcopy(gt))
    ev = core.COCOeval(coco_gt, coco_gt.loadRes(copy.deepcopy(dts)), iouType=kind)
    if max_dets is not None:
        ev.params.maxDets = max_dets
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    return ev


@pytest.mark.parametrize("kind", ["bbox", "segm", "keypoints"])
@pytest.mark.parametrize("seed", range(3))
def test_cocoeval_matches_jax(kind, seed):
    gt, dts = random_set(seed, kind)
    max_dets = [1, 2, 5] if seed == 2 and kind != "keypoints" else None
    got = run(coco_api, coco_eval_core, gt, dts, kind, max_dets)
    ref = run(jcoco_api, jcore, gt, dts, kind, max_dets)
    for field in ("precision", "recall", "scores"):
        np.testing.assert_allclose(got.eval[field], ref.eval[field], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.stats, ref.stats, rtol=0, atol=1e-12)
    assert (got.eval["precision"] > 0).any()                   # real matches


def test_use_cats_off_matches_jax():
    gt, dts = random_set(4, "bbox")
    evs = []
    for api, core in ((coco_api, coco_eval_core), (jcoco_api, jcore)):
        coco_gt = api.COCO(copy.deepcopy(gt))
        ev = core.COCOeval(coco_gt, coco_gt.loadRes(copy.deepcopy(dts)), iouType="bbox")
        ev.params.useCats = 0
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
        evs.append(ev)
    np.testing.assert_allclose(evs[0].eval["precision"], evs[1].eval["precision"],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(evs[0].stats, evs[1].stats, rtol=0, atol=1e-12)


def test_bbox_iou_helper_matches_jax():
    rng = np.random.RandomState(0)
    d = rng.rand(7, 4) * [50, 50, 20, 20]
    g = rng.rand(5, 4) * [50, 50, 20, 20]
    crowd = np.array([0, 1, 0, 0, 1])
    np.testing.assert_array_equal(coco_eval_core._bbox_iou_xywh(d, g, crowd),
                                  jcore._bbox_iou_xywh(d, g, crowd))


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURE)


@pytest.mark.parametrize("name,iou_type", [("bbox", "bbox"), ("keypoints", "keypoints")])
def test_matches_the_reference_cpp_golden(golden, name, iou_type):
    gt_json = json.loads(bytes(golden[f"{name}_gt_json"]).decode())
    dt_list = json.loads(bytes(golden[f"{name}_dt_json"]).decode())
    coco_gt = coco_api.COCO(gt_json)
    ev = coco_eval_core.COCOeval(coco_gt, coco_gt.loadRes(dt_list), iouType=iou_type)
    ev.params.imgIds = sorted({im["id"] for im in gt_json["images"]})
    ev.params.catIds = sorted({c["id"] for c in gt_json["categories"]})
    ev.evaluate()
    ev.accumulate()
    for field in ("precision", "recall", "scores"):
        ref = golden[f"{name}_{field}"].astype(np.float64)
        ours = np.asarray(ev.eval[field], np.float64)
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=1e-6)
