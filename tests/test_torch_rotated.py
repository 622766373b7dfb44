"""Rotated boxes in the port against the JAX package: the IoU (<= 1e-5, and
known values at 0, 45 and 90 degrees), NMS keeps (exact), the box deltas
and clipping (1e-5), ROIAlignRotated single- and multi-level (1e-5 x
max|ref|), and the rotated COCO evaluator (AP equal to the JAX one's).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2seg_tpu.evaluation.coco_api import COCO as JCOCO
from u2seg_tpu.evaluation import rotated_coco_evaluator as JE
from u2seg_tpu.ops import roi_align as JR
from u2seg_tpu.structures import rotated_boxes as J
from u2seg_torch.evaluation import RotatedCOCOEvaluator, RotatedCOCOeval
from u2seg_torch.evaluation import rotated_coco_evaluator as PE
from u2seg_torch.evaluation.coco_api import COCO
from u2seg_torch.ops import roi_align as PR
from u2seg_torch.structures import rotated_boxes as P

torch.set_num_threads(1)
TOL = 1e-5


def _boxes(rng, n, spread=100.0):
    return np.concatenate([rng.uniform(0, spread, (n, 2)), rng.uniform(5, 40, (n, 2)),
                           rng.uniform(-180, 180, (n, 1))], 1).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_rotated_iou_known_values():
    a = _t(np.array([[10.0, 10.0, 4.0, 4.0, 0.0]], np.float32))
    b = _t(np.array([[10.0, 10.0, 4.0, 4.0, 90.0],      # the same square
                     [10.0, 10.0, 4.0, 4.0, 45.0],      # a diamond in the square
                     [10.0, 10.0, 4.0, 4.0, 0.0],
                     [14.0, 10.0, 4.0, 4.0, 0.0],       # touching
                     [12.0, 10.0, 4.0, 4.0, 0.0],       # half overlap
                     [10.0, 10.0, 8.0, 2.0, 90.0]], np.float32))   # a cross
    iou = P.pairwise_iou_rotated(a, b)[0].numpy()
    expected_45 = (2 * (np.sqrt(2) - 1)) / (2 - 2 * (np.sqrt(2) - 1))
    np.testing.assert_allclose(iou, [1.0, expected_45, 1.0, 0.0, 1 / 3, 8 / 24], atol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pairwise_iou_rotated_matches_jax(seed):
    rng = np.random.RandomState(seed)
    b1, b2 = _boxes(rng, 23), _boxes(rng, 17)
    b2[:4] = b1[:4]
    b2[4, 4] += 90.0
    ref = np.asarray(J.pairwise_iou_rotated(jnp.asarray(b1), jnp.asarray(b2)))
    got = P.pairwise_iou_rotated(_t(b1), _t(b2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    host = PE.rotated_iou_numpy(b1, b2)                         # the evaluator's f64 twin
    np.testing.assert_allclose(host, JE.rotated_iou_numpy(b1, b2), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, host, rtol=0, atol=1e-4)


@pytest.mark.parametrize("thresh", [0.1, 0.3, 0.5, 0.7])
def test_nms_rotated_keeps_exactly_what_jax_keeps(thresh):
    rng = np.random.RandomState(int(thresh * 10))
    boxes = _boxes(rng, 60, spread=40.0)
    scores = rng.rand(60).astype(np.float32)
    scores[[3, 11]] = -np.inf                                  # invalid candidates
    scores[20] = scores[21]                                    # a tie
    for max_out in (10, 80):
        jk, jv = J.nms_rotated(jnp.asarray(boxes), jnp.asarray(scores), thresh, max_out)
        pk, pv = P.nms_rotated(_t(boxes), _t(scores), thresh, max_out)
        assert pk.dtype == torch.int32
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_nms_rotated_is_the_greedy_pass_on_a_chain():
    # A suppresses B, B would suppress C: C survives (B is gone), and C
    # suppresses D, which a fixpoint that never restores power would keep
    boxes = _t(np.array([[0, 0, 10, 10, 0], [4, 0, 10, 10, 0], [8, 0, 10, 10, 0],
                         [12, 0, 10, 10, 0]], np.float32))
    scores = _t(np.array([0.9, 0.8, 0.7, 0.6], np.float32))
    keep, valid = P.nms_rotated(boxes, scores, 0.3, 4)
    assert keep[valid].tolist() == [0, 2]


def test_deltas_and_clipping_match_jax():
    rng = np.random.RandomState(7)
    src, tgt = _boxes(rng, 40), _boxes(rng, 40)
    weights = (10.0, 10.0, 5.0, 5.0, 1.0)
    ref = np.asarray(J.get_deltas_rotated(jnp.asarray(src), jnp.asarray(tgt), weights))
    got = P.get_deltas_rotated(_t(src), _t(tgt), weights)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    back = P.apply_deltas_rotated(got, _t(src), weights)
    np.testing.assert_allclose(back.numpy(), np.asarray(J.apply_deltas_rotated(
        jnp.asarray(ref), jnp.asarray(src), weights)), rtol=TOL, atol=1e-3)
    deltas = (rng.randn(40, 5) * [0.5, 0.5, 3, 3, 1]).astype(np.float32)
    np.testing.assert_allclose(
        P.apply_deltas_rotated(_t(deltas), _t(src)).numpy(),
        np.asarray(J.apply_deltas_rotated(jnp.asarray(deltas), jnp.asarray(src))),
        rtol=TOL, atol=TOL * 100)
    boxes = _boxes(rng, 40, spread=120.0)
    boxes[:20, 4] = rng.choice([0.0, 0.5, -1.0, 359.5, 180.0, 3.0], 20)
    np.testing.assert_allclose(
        P.clip_rotated(_t(boxes), (90, 110)).numpy(),
        np.asarray(J.clip_rotated(jnp.asarray(boxes), (90, 110))), rtol=0, atol=TOL)
    np.testing.assert_allclose(P.corners(_t(boxes)).numpy(),
                               np.asarray(J.corners(jnp.asarray(boxes))), rtol=0, atol=1e-4)


def _close_rel(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * float(np.abs(ref).max()))


@pytest.mark.parametrize("s,r,scale", [(7, 0, 0.25), (5, 3, 0.5), (14, 2, 0.125)])
def test_roi_align_rotated_matches_jax(s, r, scale):
    rng = np.random.RandomState(s + r)
    feats = rng.randn(2, 24, 29, 8).astype(np.float32)
    rois = np.concatenate([rng.uniform(-10, 120, (30, 2)), rng.uniform(1, 90, (30, 2)),
                           rng.uniform(-180, 180, (30, 1))], 1).astype(np.float32)
    bidx = rng.randint(0, 2, 30).astype(np.int32)
    ref = JR.roi_align_rotated(jnp.asarray(feats), jnp.asarray(rois), jnp.asarray(bidx),
                               s, scale, r)
    got = PR.roi_align_rotated(_t(feats), _t(rois), _t(bidx), s, scale, r)
    assert got.shape == (30, s, s, 8) and got.dtype == torch.float32
    _close_rel(got.numpy(), ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_multilevel_roi_align_rotated_matches_jax(seed):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(2, n, n + 3, 8).astype(np.float32) for n in (32, 16, 8, 4)]
    rois = np.concatenate([rng.uniform(0, 128, (50, 2)), rng.uniform(4, 300, (50, 2)),
                           rng.uniform(-180, 180, (50, 1))], 1).astype(np.float32)
    bidx = rng.randint(0, 2, 50).astype(np.int32)
    ref = JR.multilevel_roi_align_rotated([jnp.asarray(f) for f in feats], jnp.asarray(rois),
                                          jnp.asarray(bidx), 7, (4, 8, 16, 32))
    got = PR.multilevel_roi_align_rotated([_t(f) for f in feats], _t(rois), _t(bidx), 7,
                                          (4, 8, 16, 32))
    _close_rel(got.numpy(), ref)


def _gt_json():
    rng = np.random.RandomState(11)
    anns, images = [], []
    for img in range(1, 4):
        images.append({"id": img, "height": 200, "width": 300})
        for _ in range(5):
            bb = [float(v) for v in _boxes(rng, 1, spread=180.0)[0]]
            anns.append({"id": len(anns) + 1, "image_id": img, "category_id": 1 + len(anns) % 2,
                         "iscrowd": 0, "bbox": bb, "area": bb[2] * bb[3]})
    return {"images": images, "annotations": anns,
            "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}


def _predictions(gt, rng, jitter):
    outs = []
    for img in gt["images"]:
        anns = [a for a in gt["annotations"] if a["image_id"] == img["id"]]
        boxes = np.array([a["bbox"] for a in anns])
        boxes = boxes + rng.randn(*boxes.shape) * jitter * [1, 1, 1, 1, 10]
        extra = np.array([_boxes(rng, 1, spread=180.0)[0]])
        outs.append({"instances": {
            "boxes": np.concatenate([boxes, extra]),
            "scores": rng.rand(len(anns) + 1),
            "classes": np.array([a["category_id"] for a in anns] + [1])}})
    return outs


@pytest.mark.parametrize("jitter", [0.0, 2.0])
def test_rotated_coco_evaluator_equals_jax(jitter):
    gt = _gt_json()
    preds = _predictions(gt, np.random.RandomState(3), jitter)
    inputs = [{"image_id": img["id"]} for img in gt["images"]]
    ev = RotatedCOCOEvaluator(COCO(gt), mode="supervised")
    jev = JE.RotatedCOCOEvaluator(JCOCO(gt), mode="supervised")
    ev.process(inputs, preds)
    jev.process(inputs, preds)
    res, ref = ev.evaluate(), jev.evaluate()
    assert RotatedCOCOeval is PE.RotatedCOCOeval          # exported as the JAX package does
    assert set(res["bbox"]) == set(ref["bbox"])
    for k, v in ref["bbox"].items():
        assert res["bbox"][k] == pytest.approx(v, abs=1e-9, nan_ok=True), k
    if jitter == 0.0:
        assert res["bbox"]["AP50"] > 90.0


def test_rotated_evaluator_ground_truth_as_predictions_scores_100():
    gt = _gt_json()
    ev = RotatedCOCOEvaluator(COCO(gt), mode="supervised")
    for img in gt["images"]:
        anns = [a for a in gt["annotations"] if a["image_id"] == img["id"]]
        ev.process([{"image_id": img["id"]}], [{"instances": {
            "boxes": np.array([a["bbox"] for a in anns]),
            "scores": np.linspace(0.9, 0.5, len(anns)),
            "classes": np.array([a["category_id"] for a in anns])}}])
    assert ev.evaluate()["bbox"]["AP"] == pytest.approx(100.0, abs=1e-6)
