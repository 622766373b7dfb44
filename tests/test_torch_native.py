"""The port's host matcher (``u2seg_torch/_native``: mask IoU, box IoU and
COCOeval's greedy matching in C++, built with g++ at first use) against its
numpy twins (``rle._iou_plain``, ``coco_eval_core._bbox_iou_xywh`` and
``_match_plain``, the port's numpy codec) and against the JAX package's
``u2seg_tpu._native`` and ``u2seg_tpu.evaluation.rle``: the five cases of
``tests/evaluation/test_native.py``, then COCOeval with the C++ and with the
twins, then the build itself (a missing compiler, a failing source, two
processes that build at once).

Tolerances: counts strings, masks, areas, match indices and ignore flags
exactly; IoU matrices exactly against the twins (the library is built with
``-ffp-contract=off``: no fused multiply-add) and to 1e-12 against the JAX
package's library (built without that flag); COCOeval's stats exactly.
"""
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from u2seg_tpu import _native as jnative
from u2seg_tpu.evaluation import rle as jrle
from u2seg_torch import _native
from u2seg_torch.evaluation import coco_api, coco_eval_core, rle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "golden", "fixtures", "cocoeval_golden.npz")
PlainCOCOeval = coco_eval_core.PlainCOCOeval          # on the numpy twins


def random_mask(rng, h=40, w=30, p=0.4):
    return (rng.rand(h, w) < p).astype(np.uint8)


def test_encode_decode_area_match_numpy_and_jax(rng):
    masks = [random_mask(rng) for _ in range(5)]
    masks += [np.ones((7, 5), np.uint8), np.zeros((6, 4), np.uint8)]
    for m in masks:
        r_np = rle.encode(m)
        got = _native.encode(m)
        assert got["counts"] == r_np["counts"] == jnative.encode(m)["counts"]
        assert got["size"] == r_np["size"]
        np.testing.assert_array_equal(_native.decode(r_np), m)
        np.testing.assert_array_equal(_native.decode(r_np), jnative.decode(r_np))
        assert _native.area(r_np) == rle.area(r_np) == jnative.area(r_np) == int(m.sum())


def test_iou_matches_the_twin_and_jax(rng):
    dts = [rle.encode(random_mask(rng)) for _ in range(4)]
    gts = [rle.encode(random_mask(rng)) for _ in range(3)]
    crowd = [0, 1, 0]
    got = _native.iou(dts, gts, crowd)
    np.testing.assert_array_equal(got, rle._iou_plain(dts, gts, crowd))
    np.testing.assert_array_equal(rle.iou(dts, gts, crowd), got)
    np.testing.assert_allclose(got, jnative.iou(dts, gts, crowd), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, jrle.iou(dts, gts, crowd), rtol=0, atol=1e-12)
    # counts as bytes, as str and as a list of runs give the same matrix
    as_str = [{"size": r["size"], "counts": r["counts"].decode("ascii")} for r in dts]
    as_list = [{"size": r["size"], "counts": rle.string_to_counts(r["counts"])} for r in dts]
    for variant in (as_str, as_list):
        np.testing.assert_array_equal(_native.iou(variant, gts, crowd), got)
    assert _native.iou([], gts, crowd).shape == (0, 3)
    assert _native.iou(dts, [], []).shape == (4, 0)


def test_merge_matches_numpy_and_jax(rng):
    masks = [random_mask(rng) for _ in range(3)]
    rles = [rle.encode(m) for m in masks]
    for intersect, ref in ((False, masks[0] | masks[1] | masks[2]),
                           (True, masks[0] & masks[1] & masks[2])):
        got = _native.merge(rles, intersect=intersect)
        np.testing.assert_array_equal(_native.decode(got), ref)
        assert got["counts"] == rle.merge(rles, intersect)["counts"]
        assert got["counts"] == jnative.merge(rles, intersect)["counts"]


def test_bbox_iou_matches_the_twin_and_jax(rng):
    dt = np.array([[0, 0, 10, 10], [5, 5, 10, 10]], np.float64)
    gt = np.array([[0, 0, 10, 10], [100, 100, 5, 5]], np.float64)
    out = _native.bbox_iou(dt, gt, [0, 0])
    assert abs(out[0, 0] - 1.0) < 1e-12 and out[0, 1] == 0.0
    assert abs(_native.bbox_iou(dt, gt, [1, 0])[1, 0] - 25 / 100) < 1e-12   # inter / area(dt)
    d = rng.rand(40, 4) * [60, 60, 30, 30]
    g = rng.rand(9, 4) * [60, 60, 30, 30]
    crowd = (rng.rand(9) < 0.3).astype(np.uint8)
    got = _native.bbox_iou(d, g, crowd)
    np.testing.assert_array_equal(got, coco_eval_core._bbox_iou_xywh(d, g, crowd))
    np.testing.assert_allclose(got, jnative.bbox_iou(d, g, crowd), rtol=0, atol=1e-12)


def test_match_matches_the_twin_and_jax(rng):
    for _ in range(10):
        d, g = rng.randint(1, 8), rng.randint(1, 6)
        ious = rng.rand(d, g)
        gt_ignore = (rng.rand(g) < 0.3).astype(np.uint8)
        order = np.argsort(gt_ignore, kind="stable")        # ignored last
        ious, gt_ignore = ious[:, order], gt_ignore[order]
        iscrowd = (rng.rand(g) < 0.2).astype(np.uint8)
        dt_out = (rng.rand(d) < 0.2).astype(np.uint8)
        thrs = np.array([0.3, 0.5, 0.75])
        got = _native.cocoeval_match(ious, gt_ignore, iscrowd, thrs, dt_out)
        plain = coco_eval_core._match_plain(ious, gt_ignore, iscrowd, thrs, dt_out)
        ref = jnative.cocoeval_match(ious, gt_ignore, iscrowd, thrs, dt_out)
        for a, b, c in zip(got, plain, ref):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def dense_set(seed, n_img=6, h=96, w=128, cats=(1, 2, 3), per_image=100):
    """GT (3-8 per image, crowd ~15%) and ``per_image`` detections per image:
    jittered GT boxes and masks of the same or another category, false
    positives, score ties."""
    rng = np.random.RandomState(seed)
    images = [{"id": i + 1, "height": h, "width": w} for i in range(n_img)]
    gts, dts = [], []

    def rect(x, y, bw, bh):
        m = np.zeros((h, w), np.uint8)
        m[max(0, int(y)):max(0, int(y + bh)), max(0, int(x)):max(0, int(x + bw))] = 1
        return m

    for img in images:
        anns = []
        for _ in range(rng.randint(3, 9)):
            x, y = rng.rand(2) * [w - 30, h - 30]
            bw, bh = rng.rand(2) * [40, 40] + 6
            m = rect(x, y, bw, bh)
            enc = rle.encode(m)
            enc["counts"] = enc["counts"].decode("ascii")
            ann = {"id": len(gts) + 1, "image_id": img["id"],
                   "category_id": int(rng.choice(cats)), "bbox": [x, y, bw, bh],
                   "segmentation": enc, "area": float(m.sum()),
                   "iscrowd": int(rng.rand() < 0.15)}
            gts.append(ann)
            anns.append(ann)
        for _ in range(per_image):
            if rng.rand() < 0.7:
                a = anns[rng.randint(len(anns))]
                jit = rng.randn(4) * rng.choice([0.5, 3, 10])
                x, y, bw, bh = np.asarray(a["bbox"]) + jit
                cat = a["category_id"] if rng.rand() < 0.8 else int(rng.choice(cats))
            else:
                x, y = rng.rand(2) * [w, h]
                bw, bh = rng.rand(2) * [40, 40] + 2
                cat = int(rng.choice(cats))
            bw, bh = max(bw, 1.0), max(bh, 1.0)
            enc = rle.encode(rect(x, y, bw, bh))
            enc["counts"] = enc["counts"].decode("ascii")
            dts.append({"image_id": img["id"], "category_id": cat, "bbox": [x, y, bw, bh],
                        "segmentation": enc,
                        "score": float(rng.choice([0.9, 0.5, rng.rand()]))})
    return ({"images": images, "annotations": gts,
             "categories": [{"id": c, "name": str(c)} for c in cats]}, dts)


def evaluate(cls, gt, dts, kind):
    coco_gt = coco_api.COCO(copy.deepcopy(gt))
    res = copy.deepcopy(dts)
    if kind == "bbox":
        res = [{k: v for k, v in d.items() if k != "segmentation"} for d in res]
    else:
        res = [{k: v for k, v in d.items() if k != "bbox"} for d in res]
    ev = cls(coco_gt, coco_gt.loadRes(res), iouType=kind)
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    return ev


def assert_same_evaluation(got, ref):
    assert got.ious.keys() == ref.ious.keys()
    for k in got.ious:
        np.testing.assert_array_equal(got.ious[k], ref.ious[k])
    assert len(got.evalImgs) == len(ref.evalImgs)
    for a, b in zip(got.evalImgs, ref.evalImgs):
        assert (a is None) == (b is None)
        if a is not None:
            for f in ("dtMatches", "gtMatches", "dtIgnore", "gtIgnore"):
                np.testing.assert_array_equal(a[f], b[f])
    np.testing.assert_array_equal(got.stats, ref.stats)


@pytest.mark.parametrize("kind", ["bbox", "segm"])
def test_cocoeval_with_the_matcher_equals_the_twins_at_100_detections(kind):
    gt, dts = dense_set(0)
    got = evaluate(coco_eval_core.COCOeval, gt, dts, kind)
    ref = evaluate(PlainCOCOeval, gt, dts, kind)
    assert_same_evaluation(got, ref)
    assert got.stats.shape == (12,) and got.stats[0] > 0        # real matches
    per_image = {}
    for e in got.evalImgs:                    # all categories, area range "all"
        if e is not None and e["aRng"] == got.params.areaRng[0]:
            per_image[e["image_id"]] = per_image.get(e["image_id"], 0) + len(e["dtIds"])
    assert sorted(per_image.values()) == [100] * len(gt["images"])


@pytest.mark.parametrize("name,iou_type", [("bbox", "bbox"), ("keypoints", "keypoints")])
def test_cocoeval_with_the_matcher_equals_the_twins_on_the_golden_set(name, iou_type):
    golden = np.load(FIXTURE)
    gt_json = json.loads(bytes(golden[f"{name}_gt_json"]).decode())
    dt_list = json.loads(bytes(golden[f"{name}_dt_json"]).decode())
    evs = []
    for cls in (coco_eval_core.COCOeval, PlainCOCOeval):
        coco_gt = coco_api.COCO(copy.deepcopy(gt_json))
        ev = cls(coco_gt, coco_gt.loadRes(copy.deepcopy(dt_list)), iouType=iou_type)
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
        evs.append(ev)
    assert_same_evaluation(*evs)
    for field in ("precision", "recall", "scores"):
        np.testing.assert_array_equal(evs[0].eval[field], evs[1].eval[field])


def test_a_missing_compiler_raises_naming_gxx(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "build"))
    m = rle.encode(np.eye(4, dtype=np.uint8))
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        rle.iou([m], [m], [0])
    assert not (tmp_path / "build").exists()


def test_a_failing_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "rle_ops.cpp"
    bad.write_text('extern "C" int rle_area( {\n')
    monkeypatch.setattr(_native, "SOURCE", str(bad))
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed to build .*error"):
        _native.build()
    assert os.listdir(tmp_path / "build") == []                 # no temporary left


BUILD_ONE = """
import sys
sys.path.insert(0, {root!r})
from u2seg_torch import _native
_native.BUILD_DIR = sys.argv[1]
import numpy as np
m = _native.encode(np.eye(5, dtype=np.uint8))
assert _native.iou([m], [m], [0])[0, 0] == 1.0
print(_native.library_path())
"""


def test_two_processes_that_build_at_once_leave_one_library(tmp_path):
    build_dir = str(tmp_path / "build")
    code = BUILD_ONE.format(root=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, build_dir],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    assert os.listdir(build_dir) == [os.path.basename(paths.pop())]


def test_collect_env_info_says_whether_the_matcher_is_built():
    from u2seg_torch.utils import env

    _native.get_lib()
    line = next(ln for ln in env.collect_env_info().splitlines()
                if ln.startswith("native rle_ops:"))
    assert line == f"native rle_ops: built ({_native.library_path()})"
