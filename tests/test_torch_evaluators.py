"""The port's evaluators against the JAX package's on the same numpy-seeded
inputs: every function of ``evaluation/hungarian.py``; Boundary IoU's
erosion (``mask_to_boundary``: the port's separable min filter against the
JAX package's ``cv2.erode``); ``SemSegEvaluator`` in its four modes with
Boundary IoU; ``pq_compute`` on ``tests/evaluation/test_panoptic_eval.py``'s
cases and on random maps; ``COCOPanopticEvaluator`` (unmatched segments
zeroed); ``COCOEvaluator`` two-pass against ``auto``; the evaluator
protocol and the result helpers.

Tolerance: metric dicts equal to 1e-9 (NaN where the other is NaN);
mappings, vote pairs, label maps and PQ counts exactly.
"""
import json
import logging
import os

import numpy as np
import pytest

from u2seg_tpu.evaluation import coco_api as jcoco_api
from u2seg_tpu.evaluation import coco_evaluator as jcoco_ev
from u2seg_tpu.evaluation import evaluator as jevaluator
from u2seg_tpu.evaluation import hungarian as jh
from u2seg_tpu.evaluation import panoptic_eval_core as jpq
from u2seg_tpu.evaluation import panoptic_evaluator as jpan_ev
from u2seg_tpu.evaluation import sem_seg_evaluator as jsem
from u2seg_tpu.evaluation import testing as jtesting
from u2seg_torch.evaluation import (
    coco_api, coco_evaluator, evaluator, hungarian, panoptic_eval_core,
    panoptic_evaluator, sem_seg_evaluator, testing,
)


def assert_same(a, b, tol=1e-9):
    """Nested dicts of numbers: same keys, |a - b| <= tol, NaN for NaN."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (sorted(a), sorted(b))
        for k in a:
            assert_same(a[k], b[k], tol)
    elif isinstance(a, str):
        assert a == b
    else:
        assert np.isnan(a) == np.isnan(b) and (np.isnan(a) or abs(a - b) <= tol), (a, b)


def renamed(d, old, new):
    """A result dict whose string values (artifact paths) point elsewhere."""
    if isinstance(d, dict):
        return {k: renamed(v, old, new) for k, v in d.items()}
    return d.replace(old, new) if isinstance(d, str) else d


# ---------------------------------------------------------------------------
# hungarian
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_majority_votes_match_jax(seed):
    rng = np.random.RandomState(seed)
    pred = rng.randint(0, 12, 200)
    gt = rng.randint(0, 5, 200)
    assert (hungarian.majority_vote_mapping(pred, gt, 15, 5)
            == jh.majority_vote_mapping(pred, gt, 15, 5))
    pred_s = rng.randint(0, 28, 300)
    gt_s = rng.randint(1, 16, 300)
    assert (hungarian.semantic_majority_vote(pred_s, gt_s, 27, 16)
            == jh.semantic_majority_vote(pred_s, gt_s, 27, 16))
    assert hungarian.majority_vote_mapping([], [], 3, 2) == {0: -1, 1: -1, 2: -1}


def random_results(rng, n_img=4, n=30, clusters=10):
    gt_by_image, results = {}, []
    for i in range(n_img):
        anns = []
        for _ in range(rng.randint(0, 5)):
            x, y, w, h = rng.rand(4) * [60, 60, 30, 30] + [0, 0, 2, 2]
            anns.append({"bbox": [x, y, w, h], "category_id": int(rng.choice([3, 8, 21]))})
        gt_by_image[i] = anns
        for a in anns:
            for _ in range(2):
                jit = rng.randn(4) * rng.choice([0.3, 4])
                results.append({"image_id": i, "bbox": list(np.asarray(a["bbox"]) + jit),
                                "score": float(rng.rand()),
                                "category_id": int(rng.randint(clusters))})
    for _ in range(n):
        results.append({"image_id": int(rng.randint(n_img + 1)),
                        "bbox": list(rng.rand(4) * [60, 60, 30, 30]),
                        "score": float(rng.rand()), "category_id": int(rng.randint(clusters))})
    return results, gt_by_image


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("thresh", [(0.6, 0.7), (0.2, 0.3)])
def test_mine_instance_pairs_matches_jax(seed, thresh):
    results, gt_by_image = random_results(np.random.RandomState(seed))
    id_map = {3: 0, 8: 1, 21: 2}
    p, g = hungarian.mine_instance_pairs(results, gt_by_image, id_map, *thresh)
    jp, jg = jh.mine_instance_pairs(results, gt_by_image, id_map, *thresh)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(g, jg)
    assert p.dtype == jp.dtype == np.int64


@pytest.mark.parametrize("seed", range(3))
def test_mine_semantic_pairs_matches_jax(seed):
    rng = np.random.RandomState(seed)
    pred = np.repeat(np.repeat(rng.randint(0, 8, (6, 8)), 5, 0), 5, 1)
    gt = np.repeat(np.repeat(rng.choice([0, 1, 2, 5, 16, 255], (6, 8)), 5, 0), 5, 1)
    for thr in (0.15, 0.05):
        assert (hungarian.mine_semantic_pairs(pred, gt, thr)
                == jh.mine_semantic_pairs(pred, gt, thr))


def test_mapping_files_are_the_same_bytes(tmp_path):
    m = {0: 3, 1: -1, 12: 7}
    hungarian.save_mapping(m, str(tmp_path / "p" / "m.json"))
    jh.save_mapping(m, str(tmp_path / "j" / "m.json"))
    assert ((tmp_path / "p" / "m.json").read_bytes()
            == (tmp_path / "j" / "m.json").read_bytes())
    assert hungarian.load_mapping(str(tmp_path / "j" / "m.json")) == m
    assert jh.load_mapping(str(tmp_path / "p" / "m.json")) == m


def test_remap_instance_results_matches_jax():
    results, _ = random_results(np.random.RandomState(5))
    mapping = {c: (c % 3 if c % 4 else -1) for c in range(10)}
    c2d = {0: 3, 1: 8, 2: 21}
    assert (hungarian.remap_instance_results(results, mapping, c2d)
            == jh.remap_instance_results(results, mapping, c2d))


# ---------------------------------------------------------------------------
# Boundary IoU without OpenCV
# ---------------------------------------------------------------------------

def coarse(rng, h, w, n, cell=(3, 4)):
    m = rng.randint(0, n, (h // cell[0] + 1, w // cell[1] + 1)).astype(np.uint8)
    return np.repeat(np.repeat(m, cell[0], 0), cell[1], 1)[:h, :w]


@pytest.mark.parametrize("h,w,n", [(30, 44, 5), (1, 17, 3), (9, 1, 3), (3, 3, 2),
                                   (80, 64, 17), (480, 640, 17), (427, 640, 29)])
def test_mask_to_boundary_matches_cv2(h, w, n):
    m = coarse(np.random.RandomState(h + w), h, w, n)
    got = sem_seg_evaluator.mask_to_boundary(m)
    ref = jsem.mask_to_boundary(m)
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_port_always_reports_boundary_iou():
    ev = sem_seg_evaluator.SemSegEvaluator(mode="supervised", num_pred_classes=4)
    gt = np.zeros((16, 16), np.int64)
    gt[:, 8:] = 1
    ev.process([{"sem_seg_gt": gt}], [{"sem_seg": gt}])
    res = ev.evaluate()["sem_seg"]
    assert res["BoundaryIoU-1"] == pytest.approx(100.0)


# ---------------------------------------------------------------------------
# SemSegEvaluator
# ---------------------------------------------------------------------------

def sem_inputs(seed, n_img=3, h=48, w=64):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_img):
        gt = coarse(rng, h, w, 54, (8, 8)).astype(np.int64)        # 0..53
        gt[rng.rand(h, w) < 0.05] = 255
        pred = coarse(rng, h, w, 28, (8, 8)).astype(np.int64)      # clusters
        pred[gt > 0] = np.where(rng.rand(*gt.shape) < 0.7, (gt % 27) + 1, pred)[gt > 0]
        out.append(({"sem_seg_gt": gt}, {"sem_seg": pred}))
    return out


def run_sem(mod, mode, data, mdir):
    ev = mod.SemSegEvaluator(mode=mode, num_pred_classes=28, matching_dir=mdir)
    ev.reset()
    for inp, out in data:
        ev.process([inp], [out])
    return ev.evaluate()


@pytest.mark.parametrize("mode", ["supervised", "hungarian_matching", "eval", "auto"])
@pytest.mark.parametrize("seed", range(2))
def test_sem_seg_evaluator_matches_jax(tmp_path, mode, seed):
    data = sem_inputs(seed)
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    if mode == "eval":                      # pass 1 of each package first
        run_sem(sem_seg_evaluator, "hungarian_matching", data, pdir)
        run_sem(jsem, "hungarian_matching", data, jdir)
    got = run_sem(sem_seg_evaluator, mode, data, pdir)
    ref = run_sem(jsem, mode, data, jdir)
    assert_same(renamed(got, pdir, jdir), ref)
    if mode in ("eval", "auto", "supervised"):
        assert "BoundaryIoU-1" in got["sem_seg"]
    if mode != "supervised":
        assert ((tmp_path / "port" / "semantic_mapping.json").read_bytes()
                == (tmp_path / "jax" / "semantic_mapping.json").read_bytes())


def test_transfer_gt_matches_jax():
    gt = np.random.RandomState(0).choice(list(range(54)) + [255], (20, 30))
    np.testing.assert_array_equal(sem_seg_evaluator.transfer_gt_to_supercategories(gt),
                                  jsem.transfer_gt_to_supercategories(gt))


# ---------------------------------------------------------------------------
# PQ
# ---------------------------------------------------------------------------

CATS = {1: {"id": 1, "isthing": 1}, 2: {"id": 2, "isthing": 0}}


def seg(sid, cat, **kw):
    return dict({"id": sid, "category_id": cat}, **kw)


def case(name):
    """The cases of tests/evaluation/test_panoptic_eval.py: (gt, pred,
    gt_segments, pred_segments)."""
    z = lambda: np.zeros((10, 10), np.int32)
    gt, pred = z(), z()
    if name == "perfect":
        gt[:5], gt[5:] = 1, 2
        return gt, gt.copy(), [seg(1, 1), seg(2, 2)], [seg(1, 1), seg(2, 2)]
    if name == "partial":
        gt[:] = 1
        pred[:8] = 1
        return gt, pred, [seg(1, 1)], [seg(1, 1)]
    if name == "below_half":
        gt[:5], gt[5:] = 1, 9
        pred[4:] = 1
        return gt, pred, [seg(1, 1), seg(9, 2)], [seg(1, 1)]
    if name == "mostly_void":
        gt[:5] = 1
        pred[4:] = 1
        return gt, pred, [seg(1, 1)], [seg(1, 1)]
    if name == "class_mismatch":
        return gt + 1, pred + 1, [seg(1, 1)], [seg(1, 2)]
    if name == "void_excuses":
        gt[0, 0] = 1
        pred[:] = 5
        return gt, pred, [seg(1, 1)], [seg(5, 1)]
    if name == "crowd":
        gt[:] = 7
        pred[:] = 3
        return gt, pred, [seg(7, 1, iscrowd=1)], [seg(3, 1)]
    if name == "absent_category":
        return gt + 1, pred + 1, [seg(1, 1)], [seg(1, 1)]
    raise KeyError(name)


def random_panoptic(seed, n=3):
    rng = np.random.RandomState(seed)
    cats = {c: {"id": c, "isthing": int(c < 5)} for c in range(1, 9)}
    gts, preds = [], []
    for _ in range(n):
        gt = np.repeat(np.repeat(rng.randint(0, 7, (6, 8)), 6, 0), 6, 1)
        gsegs = [seg(i, int(rng.randint(1, 9)), iscrowd=int(rng.rand() < 0.15))
                 for i in range(1, 7)]
        pred = gt.copy()
        noise = rng.rand(*gt.shape) < 0.3
        pred[noise] = rng.randint(0, 9, noise.sum())
        psegs = [seg(i, g["category_id"] if rng.rand() < 0.8 else int(rng.randint(1, 9)))
                 for i, g in zip(range(1, 7), gsegs)] + [seg(7, 2), seg(8, 6)]
        gts.append((gt, gsegs))
        preds.append((pred, psegs))
    return gts, preds, cats


@pytest.mark.parametrize("name", ["perfect", "partial", "below_half", "mostly_void",
                                  "class_mismatch", "void_excuses", "crowd",
                                  "absent_category"])
def test_pq_cases_match_jax(name):
    gt, pred, gs, ps = case(name)
    a = panoptic_eval_core.pq_compute_single_image(gt, pred, gs, ps, CATS)
    b = jpq.pq_compute_single_image(gt, pred, gs, ps, CATS)
    for c in (1, 2):
        assert (a[c].tp, a[c].fp, a[c].fn) == (b[c].tp, b[c].fp, b[c].fn)
        assert abs(a[c].iou - b[c].iou) <= 1e-9
    assert_same(panoptic_eval_core.pq_compute([(gt, gs)], [(pred, ps)], CATS),
                jpq.pq_compute([(gt, gs)], [(pred, ps)], CATS))


@pytest.mark.parametrize("seed", range(4))
def test_pq_random_maps_match_jax(seed):
    gts, preds, cats = random_panoptic(seed)
    got = panoptic_eval_core.pq_compute(gts, preds, cats)
    assert_same(got, jpq.pq_compute(gts, preds, cats))
    assert got["All"]["n"] > 0


def test_pq_refuses_unknown_segments_like_jax():
    gt, pred, gs, ps = case("perfect")
    for mod in (panoptic_eval_core, jpq):
        with pytest.raises(KeyError, match="segments_info"):
            mod.pq_compute_single_image(gt, pred, gs, ps[:1], CATS)


# ---------------------------------------------------------------------------
# COCOPanopticEvaluator
# ---------------------------------------------------------------------------

def panoptic_inputs(seed, cluster_num=300):
    rng = np.random.RandomState(seed)
    data = []
    for _ in range(3):
        gt = np.zeros((12, 16), np.int64)
        gt[:6], gt[6:, :8], gt[6:, 8:] = 11, 12, 13
        gt[:3, :4] = 0
        gsegs = [seg(11, 1), seg(12, cluster_num + 2), seg(13, 18, iscrowd=int(rng.rand() < 0.3))]
        pred = gt.copy()
        pred[rng.rand(12, 16) < 0.2] = 21
        pred[gt == 0] = 22
        psegs = [seg(11, 0, isthing=True), seg(12, int(rng.choice([1, 2])), isthing=False),
                 seg(13, 1, isthing=True), seg(21, 1, isthing=True), seg(22, 3, isthing=False)]
        data.append(({"pan_gt": gt, "gt_segments": gsegs},
                     {"panoptic": pred, "segments": psegs}))
    cats = {1: {"id": 1, "isthing": 1}, 18: {"id": 18, "isthing": 1}}
    cats.update({cluster_num + s: {"id": cluster_num + s, "isthing": 0} for s in (1, 2, 3)})
    return data, cats


@pytest.mark.parametrize("setup", ["eval", "auto_detect", "supervised", "matching"])
def test_panoptic_evaluator_matches_jax(tmp_path, setup):
    data, cats = panoptic_inputs(len(setup))
    results = []
    for mod, h, d in ((panoptic_evaluator, hungarian, tmp_path / "p"),
                      (jpan_ev, jh, tmp_path / "j")):
        if setup != "matching":
            h.save_mapping({0: 0, 1: -1, 2: 1}, str(d / "instance_mapping.json"))
            h.save_mapping({0: 0, 1: 2, 2: -1, 3: 1}, str(d / "semantic_mapping.json"))
        mode = {"eval": "eval", "auto_detect": None, "supervised": None,
                "matching": None}[setup]
        ev = mod.COCOPanopticEvaluator(cats, {0: 1, 1: 18}, cluster_num=300,
                                       matching_dir=str(d), mode=mode,
                                       supervised=setup == "supervised")
        ev.reset()
        for inp, out in data:
            ev.process([inp], [out])
        results.append(ev.evaluate())
    assert_same(*results)
    if setup == "matching":
        assert results[0] == {}
    if setup == "eval":
        assert results[0]["panoptic_seg"]["PQ"] > 0


def test_panoptic_evaluator_zeroes_unmatched_segments(tmp_path):
    hungarian.save_mapping({0: -1}, str(tmp_path / "instance_mapping.json"))
    hungarian.save_mapping({0: 0}, str(tmp_path / "semantic_mapping.json"))
    ev = panoptic_evaluator.COCOPanopticEvaluator(
        {1: {"id": 1, "isthing": 1}}, {0: 1}, cluster_num=300,
        matching_dir=str(tmp_path), mode="eval")
    pred = np.full((4, 4), 3, np.int32)
    ev.process([{"pan_gt": np.zeros((4, 4), np.int32), "gt_segments": []}],
               [{"panoptic": pred, "segments": [{"id": 3, "category_id": 0,
                                                 "isthing": True}]}])
    converted = []
    for pan, segments in ev._predictions:
        for s in segments:
            conv, pan = ev._convert_segment(s, pan)
            converted.append(conv)
        assert (pan == 0).all()
    assert converted == [None] and (pred == 3).all()      # the input is untouched
    assert ev.evaluate()["panoptic_seg"]["PQ"] == 0.0


# ---------------------------------------------------------------------------
# COCOEvaluator
# ---------------------------------------------------------------------------

def coco_case(seed):
    rng = np.random.RandomState(seed)
    images = [{"id": i, "height": 80, "width": 96} for i in (1, 2, 3)]
    anns, inputs, outputs = [], [], []
    for img in images:
        boxes, scores, classes = [], [], []
        for k in range(rng.randint(1, 4)):
            x, y = rng.rand(2) * 50
            w, h = rng.rand(2) * 25 + 8
            cat = int(rng.choice([17, 18, 44]))
            anns.append({"id": len(anns) + 1, "image_id": img["id"], "category_id": cat,
                         "bbox": [x, y, w, h], "area": w * h, "iscrowd": 0})
            jit = rng.randn(4) * 0.8
            boxes.append([x + jit[0], y + jit[1], x + w + jit[2], y + h + jit[3]])
            scores.append(float(rng.choice([0.95, 0.7, 0.3])))
            classes.append({17: 5, 18: 2, 44: 7}[cat] if rng.rand() < 0.85 else 9)
        boxes.append([1.0, 1.0, 10.0, 12.0])
        scores.append(0.9)
        classes.append(int(rng.randint(10)))
        inputs.append({"image_id": img["id"]})
        outputs.append({"instances": {"boxes": np.array(boxes), "scores": np.array(scores),
                                      "classes": np.array(classes)}})
    cats = [{"id": c, "name": str(c)} for c in (17, 18, 44)]
    return {"images": images, "annotations": anns, "categories": cats}, inputs, outputs


def run_coco(api, mod, gt, inputs, outputs, mode, mdir):
    ev = mod.COCOEvaluator(api.COCO(gt), mode=mode, num_clusters=10, tasks=("bbox",),
                           matching_dir=mdir)
    ev.reset()
    ev.process(inputs, outputs)
    return ev.evaluate()


@pytest.mark.parametrize("seed", range(3))
def test_coco_evaluator_two_pass_equals_auto_and_jax(tmp_path, seed):
    gt, inputs, outputs = coco_case(seed)
    res = {}
    for tag, api, mod in (("p", coco_api, coco_evaluator), ("j", jcoco_api, jcoco_ev)):
        two = str(tmp_path / tag / "two")
        r1 = run_coco(api, mod, gt, inputs, outputs, "hungarian_matching", two)
        assert r1 == {"instance_mapping": os.path.join(two, "instance_mapping.json")}
        res[tag, "eval"] = run_coco(api, mod, gt, inputs, outputs, "eval", two)
        res[tag, "auto"] = run_coco(api, mod, gt, inputs, outputs, "auto",
                                    str(tmp_path / tag / "auto"))
        res[tag, "supervised"] = run_coco(api, mod, gt, inputs, outputs, "supervised", "")
    for mode in ("eval", "auto", "supervised"):
        assert_same(res["p", mode], res["j", mode])
    assert_same(res["p", "eval"], res["p", "auto"])
    assert res["p", "auto"]["bbox"]["AP"] > 0


def test_coco_evaluator_segm_and_keypoints_tasks_match_jax():
    from u2seg_torch.evaluation import rle

    gt, inputs, outputs = coco_case(7)
    for a in gt["annotations"]:
        x, y, w, h = a["bbox"]
        a["segmentation"] = [[x, y, x + w, y, x + w, y + h, x, y + h]]
        a["keypoints"] = (np.random.RandomState(a["id"]).rand(51) * 40).tolist()
        a["num_keypoints"] = 17
    for out in outputs:
        inst = out["instances"]
        n = len(inst["scores"])
        rles = []
        for b in inst["boxes"]:
            m = np.zeros((80, 96), np.uint8)
            m[int(max(b[1], 0)):int(b[3]), int(max(b[0], 0)):int(b[2])] = 1
            r = rle.encode(m)
            r["counts"] = r["counts"].decode("ascii")
            rles.append(r)
        inst["rles"] = rles
        inst["keypoints"] = np.random.RandomState(n).rand(n, 17, 3) * 40
    got = coco_evaluator.COCOEvaluator(coco_api.COCO(gt), tasks=("bbox", "segm", "keypoints"))
    ref = jcoco_ev.COCOEvaluator(jcoco_api.COCO(gt), tasks=("bbox", "segm", "keypoints"))
    for ev in (got, ref):
        ev.reset()
        ev.process(inputs, outputs)
    a, b = got.evaluate(), ref.evaluate()
    assert sorted(a) == ["bbox", "keypoints", "segm"]
    assert_same(a, b)


# ---------------------------------------------------------------------------
# protocol and helpers
# ---------------------------------------------------------------------------

class Recorder:
    def __init__(self, key, log):
        self.key, self.log = key, log

    def reset(self):
        self.log.append(("reset", self.key))

    def process(self, inputs, outputs):
        self.log.append(("process", self.key, len(inputs)))

    def evaluate(self):
        self.log.append(("evaluate", self.key))
        return {self.key: {"v": 1.0}} if self.key != "none" else None


def test_evaluators_run_in_list_order_like_jax():
    logs = []
    for mod in (evaluator, jevaluator):
        log = []
        ev = mod.DatasetEvaluators([Recorder(k, log) for k in ("sem", "none", "coco")])
        res = mod.inference_on_dataset(lambda x: [0] * len(x), [[1, 2], [3]], ev)
        assert list(res) == ["sem", "coco"]
        logs.append(log)
        with pytest.raises(AssertionError, match="Duplicate"):
            mod.DatasetEvaluators([Recorder("a", []), Recorder("a", [])]).evaluate()
    assert logs[0] == logs[1]
    assert [e for e in logs[0] if e[0] == "evaluate"] == [
        ("evaluate", "sem"), ("evaluate", "none"), ("evaluate", "coco")]


def test_result_helpers_match_jax(caplog):
    results = {"bbox": {"AP": 41.5, "AP-cat": 3.0}, "sem_seg": {"mIoU": 50.0},
               "note": "x"}
    expected = [("bbox", "AP", 41.0, 1.0), ("sem_seg", "mIoU", 49.0, 0.5)]
    assert testing.verify_results(expected, results) == jtesting.verify_results(
        expected, results) is False
    assert testing.verify_results([], results) is True
    assert testing.verify_results(expected[:1], results) is True
    caplog.clear()
    with caplog.at_level(logging.INFO):
        testing.print_csv_format(results)
        port = [r.getMessage() for r in caplog.records]
        caplog.clear()
        jtesting.print_csv_format(results)
        assert port == [r.getMessage() for r in caplog.records]
    assert (testing.flatten_results_dict({"a": {"b": 1, "c": {"d": 2.5}}})
            == jtesting.flatten_results_dict({"a": {"b": 1, "c": {"d": 2.5}}}))
    assert json.dumps(port)


@pytest.mark.parametrize("mode", ["hungarian_matching", "auto"])
def test_no_detection_writes_no_instance_mapping_like_jax(tmp_path, mode):
    """With no detection at all the instance pass writes no mapping (so a
    later panoptic evaluation cannot find one), in both packages."""
    gt, inputs, _ = coco_case(0)
    empty = [{"instances": {"boxes": np.zeros((0, 4)), "scores": np.zeros(0),
                            "classes": np.zeros(0, np.int64)}}] * len(inputs)
    for tag, api, mod in (("p", coco_api, coco_evaluator), ("j", jcoco_api, jcoco_ev)):
        d = tmp_path / tag
        assert run_coco(api, mod, gt, inputs, empty, mode, str(d)) == {}
        assert not (d / "instance_mapping.json").exists()
