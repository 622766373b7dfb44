"""The Pascal VOC, LVIS and Cityscapes dataset families of u2seg_torch vs the
JAX package, on the CPU: the loaders on files the test writes (VOC XML, an
LVIS json, a Cityscapes tree with instance-id PNGs, label-id PNGs and polygon
jsons) compared dict for dict, and the evaluators on seeded predictions
compared metric for metric; then the port of the JAX package's
``tests/evaluation/test_cityscapes_official.py`` (the official instance
protocol's hand-built cases) on the port's ``evaluate_instance_ap``.

Tolerances: the loaders' dicts equal (boxes, areas, RLE strings, ids); the
metrics equal to 1e-12 (both packages run the same float64 numpy in the same
order), nan where the JAX package gives nan.
"""
import json
import math
import os

import numpy as np
import pytest
from PIL import Image

from u2seg_tpu.data import cityscapes as jcity
from u2seg_tpu.data import lvis as jlvis
from u2seg_tpu.data import pascal_voc as jvoc
from u2seg_tpu.data.catalog import DatasetCatalog as JDatasetCatalog
from u2seg_tpu.data.catalog import MetadataCatalog as JMetadataCatalog
from u2seg_tpu.evaluation import cityscapes_evaluator as jcity_eval
from u2seg_tpu.evaluation import cityscapes_instance_ap as jcity_ap
from u2seg_tpu.evaluation import lvis_evaluator as jlvis_eval
from u2seg_tpu.evaluation import pascal_voc_evaluator as jvoc_eval
from u2seg_tpu.evaluation import rle as jrle
from u2seg_tpu.evaluation.coco_api import COCO as JCOCO
from u2seg_torch.data import cityscapes as tcity
from u2seg_torch.data import lvis as tlvis
from u2seg_torch.data import pascal_voc as tvoc
from u2seg_torch.data.catalog import DatasetCatalog, MetadataCatalog
from u2seg_torch.evaluation import cityscapes_evaluator as tcity_eval
from u2seg_torch.evaluation import lvis_evaluator as tlvis_eval
from u2seg_torch.evaluation import pascal_voc_evaluator as tvoc_eval
from u2seg_torch.evaluation import rle
from u2seg_torch.evaluation.cityscapes_instance_ap import evaluate_instance_ap
from u2seg_torch.evaluation.coco_api import COCO


def same_metrics(got, ref):
    """Nested metric dicts equal to 1e-12, nan where the reference is."""
    assert type(got) is type(ref) or isinstance(got, dict) and isinstance(ref, dict)
    if isinstance(ref, dict):
        assert list(got) == list(ref)
        for k in ref:
            same_metrics(got[k], ref[k])
    elif isinstance(ref, (float, np.floating)) and math.isnan(ref):
        assert math.isnan(got)
    elif isinstance(ref, np.ndarray):
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    else:
        assert abs(got - ref) <= 1e-12 * max(1.0, abs(ref)), (got, ref)


def _box_mask(h, w, y0, x0, y1, x1):
    m = np.zeros((h, w), bool)
    m[y0:y1, x0:x1] = True
    return m


# ---------------------------------------------------------------------------
# Pascal VOC
# ---------------------------------------------------------------------------

def write_voc(root, n=6, seed=0):
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "ImageSets", "Main"))
    os.makedirs(os.path.join(root, "Annotations"))
    ids = [f"2007_{i:06d}" for i in range(n)]
    with open(os.path.join(root, "ImageSets", "Main", "val.txt"), "w") as f:
        f.write("\n".join(ids) + "\n\n")
    names = list(jvoc.VOC_CLASS_NAMES) + ["unicorn"]       # one unknown class
    for fid in ids:
        objs = []
        for j in range(rng.randint(1, 6)):
            x0, y0 = rng.randint(1, 200, 2)
            x1, y1 = x0 + rng.randint(5, 150), y0 + rng.randint(5, 150)
            diff = ("" if j == 0 else
                    f"<difficult>{int(rng.rand() < 0.3)}</difficult>")
            objs.append(f"<object><name>{names[rng.randint(len(names))]}</name>{diff}"
                        f"<bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin><xmax>{x1}</xmax>"
                        f"<ymax>{y1}</ymax></bndbox></object>")
        with open(os.path.join(root, "Annotations", fid + ".xml"), "w") as f:
            f.write(f"<annotation><filename>{fid}.jpg</filename><size><width>500</width>"
                    f"<height>375</height><depth>3</depth></size>{''.join(objs)}"
                    f"</annotation>")
    return ids


def test_voc_loader_matches_jax(tmp_path):
    ids = write_voc(str(tmp_path))
    ref = jvoc.load_voc_instances(str(tmp_path), "val")
    got = tvoc.load_voc_instances(str(tmp_path), "val")
    assert got == ref and [d["image_id"] for d in got] == ids
    assert sum(len(d["annotations"]) for d in got) > 10
    assert {a["difficult"] for d in got for a in d["annotations"]} == {0, 1}
    name = "torch_zoo_datasets_voc_val"
    for reg, cat, meta in ((tvoc.register_pascal_voc, DatasetCatalog, MetadataCatalog),
                           (jvoc.register_pascal_voc, JDatasetCatalog, JMetadataCatalog)):
        reg(name, str(tmp_path), "val", 2007)
        assert cat.get(name) == ref
        m = meta.get(name)
        assert (m.evaluator_type, m.year, m.split) == ("pascal_voc", 2007, "val")
        assert list(m.thing_classes) == list(jvoc.VOC_CLASS_NAMES)


def voc_predictions(dicts, seed):
    """Per image: jittered copies of its boxes (some with the wrong class)
    and random boxes, scores drawn at random."""
    rng = np.random.RandomState(seed)
    out = []
    for d in dicts:
        boxes, classes = [], []
        for a in d["annotations"]:
            x, y, w, h = a["bbox"]
            if rng.rand() < 0.8:
                boxes.append([x, y, x + w, y + h] + rng.randn(4) * 6)
                classes.append(a["category_id"] if rng.rand() < 0.8 else rng.randint(20))
        for _ in range(3):
            x0, y0 = rng.rand(2) * 300
            boxes.append([x0, y0, x0 + rng.rand() * 150 + 5, y0 + rng.rand() * 150 + 5])
            classes.append(rng.randint(20))
        out.append({"instances": {"boxes": np.array(boxes), "classes": np.array(classes),
                                  "scores": rng.rand(len(boxes))}})
    return out


@pytest.mark.parametrize("year", [2007, 2012])
def test_voc_evaluator_matches_jax(tmp_path, year):
    write_voc(str(tmp_path), n=12, seed=1)
    dicts = jvoc.load_voc_instances(str(tmp_path), "val")
    outputs = voc_predictions(dicts, seed=2)
    res = []
    for mod in (tvoc_eval, jvoc_eval):
        ev = mod.PascalVOCDetectionEvaluator(jvoc.VOC_CLASS_NAMES, year=year)
        ev.reset()
        ev.process(dicts, outputs)
        res.append(ev.evaluate())
    same_metrics(*res)
    assert 0 < res[1]["bbox"]["AP50"] < 100


def test_voc_ap_matches_jax():
    rng = np.random.RandomState(3)
    for _ in range(20):
        n = rng.randint(1, 30)
        rec = np.sort(rng.rand(n))
        prec = rng.rand(n)
        for use_07 in (True, False):
            same_metrics(tvoc_eval.voc_ap(rec, prec, use_07),
                         jvoc_eval.voc_ap(rec, prec, use_07))
    gt = {0: {"bbox": [[0, 0, 10, 10], [20, 20, 40, 40]], "difficult": [0, 1]}}
    dets = [{"image_id": 0, "bbox": [1, 1, 10, 10], "score": 0.9},
            {"image_id": 0, "bbox": [20, 20, 40, 40], "score": 0.8},
            {"image_id": 1, "bbox": [0, 0, 5, 5], "score": 0.7}]
    for th in (0.5, 0.75):
        same_metrics(tvoc_eval.voc_eval_class(gt, dets, th),
                     jvoc_eval.voc_eval_class(gt, dets, th))
    assert math.isnan(tvoc_eval.voc_eval_class({}, dets))


# ---------------------------------------------------------------------------
# LVIS
# ---------------------------------------------------------------------------

def lvis_json(n_img=6, n_cat=8, seed=0, all_areas=False):
    """Some annotations without an area (the loader takes the box's); the
    evaluators' GT needs one on every annotation, as COCOeval does."""
    rng = np.random.RandomState(seed)
    cats = [{"id": c + 1, "name": f"thing_{c}", "synonyms": [f"thing_{c}", f"alias_{c}"],
             "frequency": "rcf"[c % 3]} for c in range(n_cat)]
    del cats[2]["synonyms"]                                 # falls back on the name
    images, anns = [], []
    for i in range(n_img):
        img = {"id": 100 + i, "height": 120, "width": 160,
               "not_exhaustive_category_ids": [int(rng.randint(1, n_cat + 1))],
               "neg_category_ids": sorted({int(c) for c in rng.randint(1, n_cat + 1, 2)})}
        if i % 2:
            img["coco_url"] = f"http://images.cocodataset.org/val2017/{i:012d}.jpg"
        else:
            img["file_name"] = f"val2017/{i:012d}.jpg"
        images.append(img)
        for _ in range(rng.randint(1, 5)):
            x, y = rng.rand(2) * 100
            w, h = rng.rand(2) * 50 + 4
            poly = [x, y, x + w, y, x + w, y + h, x, y + h]
            ann = {"id": len(anns) + 1, "image_id": 100 + i,
                   "category_id": int(rng.randint(1, n_cat + 1)),
                   "bbox": [x, y, w, h], "segmentation": [poly]}
            if rng.rand() < 0.7 or all_areas:
                ann["area"] = w * h
            anns.append(ann)
    return {"images": images, "annotations": anns, "categories": cats}


def test_lvis_loader_matches_jax(tmp_path):
    path = str(tmp_path / "lvis_v1_val.json")
    with open(path, "w") as f:
        json.dump(lvis_json(), f)
    ref = jlvis.load_lvis_json(path, "/data/coco", "torch_zoo_datasets_lvis_j")
    got = tlvis.load_lvis_json(path, "/data/coco", "torch_zoo_datasets_lvis_t")
    assert got == ref and len(got) == 6
    assert {os.path.dirname(d["file_name"]) for d in got} == {"/data/coco/val2017"}
    mj = JMetadataCatalog.get("torch_zoo_datasets_lvis_j")
    mt = MetadataCatalog.get("torch_zoo_datasets_lvis_t")
    assert mt.thing_classes == mj.thing_classes and mt.thing_classes[2] == "thing_2"
    assert mt.thing_dataset_id_to_contiguous_id == mj.thing_dataset_id_to_contiguous_id
    tlvis.register_lvis_instances("torch_zoo_datasets_lvis_r", {"note": "x"}, path, "/img")
    assert len(DatasetCatalog.get("torch_zoo_datasets_lvis_r")) == 6
    m = MetadataCatalog.get("torch_zoo_datasets_lvis_r")
    assert (m.evaluator_type, m.json_file, m.note) == ("lvis", path, "x")


def lvis_predictions(gt: dict, seed, segm: bool):
    rng = np.random.RandomState(seed)
    inputs, outputs = [], []
    for img in gt["images"]:
        anns = [a for a in gt["annotations"] if a["image_id"] == img["id"]]
        boxes, classes = [], []
        for a in anns:
            x, y, w, h = a["bbox"]
            boxes.append([x, y, x + w, y + h] + rng.randn(4) * 3)
            classes.append(a["category_id"] if rng.rand() < 0.8 else rng.randint(1, 9))
        for _ in range(4):
            x, y = rng.rand(2) * 100
            boxes.append([x, y, x + rng.rand() * 50 + 4, y + rng.rand() * 50 + 4])
            classes.append(rng.randint(1, 9))
        inst = {"boxes": np.array(boxes), "classes": np.array(classes),
                "scores": rng.rand(len(boxes))}
        if segm:
            masks = []
            for x0, y0, x1, y1 in inst["boxes"]:
                m = np.zeros((img["height"], img["width"]), np.uint8)
                m[max(int(y0), 0):max(int(y1), 0), max(int(x0), 0):max(int(x1), 0)] = 1
                masks.append(rle.encode(m))
            inst["rles"] = masks
        inputs.append({"image_id": img["id"]})
        outputs.append({"instances": inst})
    return inputs, outputs


@pytest.mark.parametrize("segm", [False, True], ids=["bbox", "bbox_segm"])
def test_lvis_evaluator_matches_jax(segm):
    gt = lvis_json(n_img=8, seed=4, all_areas=True)
    inputs, outputs = lvis_predictions(gt, 5, segm)
    res = []
    for mod, coco in ((tlvis_eval, COCO), (jlvis_eval, JCOCO)):
        ev = mod.LVISEvaluator(coco(json.loads(json.dumps(gt))))
        ev.reset()
        ev.process(inputs, outputs)
        res.append(ev.evaluate())
    same_metrics(*res)
    assert list(res[1]) == (["bbox", "segm"] if segm else ["bbox"])
    assert 0 < res[1]["bbox"]["AP50"] < 100
    empty = tlvis_eval.LVISEvaluator(COCO(gt))
    assert empty.evaluate() == {}


# ---------------------------------------------------------------------------
# Cityscapes
# ---------------------------------------------------------------------------

CITIES = {"frankfurt": 2, "lindau": 1}


def write_cityscapes(root, seed=0, h=64, w=128):
    """leftImg8bit PNGs, gtFine instanceIds (16-bit: things label*1000+k,
    groups and stuff their label id), labelIds and polygon jsons."""
    rng = np.random.RandomState(seed)
    for city, n in CITIES.items():
        img_dir = os.path.join(root, "leftImg8bit", "val", city)
        gt_dir = os.path.join(root, "gtFine", "val", city)
        os.makedirs(img_dir)
        os.makedirs(gt_dir)
        for i in range(n):
            stem = f"{city}_{i:06d}_000019"
            Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
                os.path.join(img_dir, stem + "_leftImg8bit.png"))
            inst = np.full((h, w), 7, np.uint16)                  # road
            inst[:8] = 23                                         # sky
            objs = []
            n_obj = rng.randint(3, 7)
            for k in range(n_obj):
                label = int(rng.choice([24, 25, 26, 27, 28, 31, 32, 33, 17]))
                y0, x0 = rng.randint(0, h - 8), rng.randint(0, w - 8)
                y1, x1 = y0 + rng.randint(4, 30), x0 + rng.randint(4, 40)
                # the last region of an image is a group (a thing class's
                # label id alone), or a pole where the class is 17
                value = label * 1000 + k if k < n_obj - 1 else label
                inst[y0:y1, x0:x1] = value
                objs.append({"label": str(label), "polygon": [[x0, y0], [x1, y0], [x1, y1]]})
            Image.fromarray(inst).save(os.path.join(gt_dir, stem + "_gtFine_instanceIds.png"))
            Image.fromarray(np.where(inst >= 1000, inst // 1000, inst).astype(np.uint8)).save(
                os.path.join(gt_dir, stem + "_gtFine_labelIds.png"))
            with open(os.path.join(gt_dir, stem + "_gtFine_polygons.json"), "w") as f:
                json.dump({"imgHeight": h, "imgWidth": w, "objects": objs}, f)


@pytest.fixture(scope="module")
def city_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cityscapes"))
    write_cityscapes(root)
    return root


def city_dirs(root):
    return os.path.join(root, "leftImg8bit", "val"), os.path.join(root, "gtFine", "val")


def test_cityscapes_loaders_match_jax(city_root):
    ref = jcity.load_cityscapes_instances(*city_dirs(city_root))
    got = tcity.load_cityscapes_instances(*city_dirs(city_root))
    assert got == ref and len(got) == sum(CITIES.values())
    anns = [a for d in got for a in d["annotations"]]
    assert {a["iscrowd"] for a in anns} == {0, 1} and len(anns) >= 8
    sem = tcity.load_cityscapes_semantic(*city_dirs(city_root))
    assert sem == jcity.load_cityscapes_semantic(*city_dirs(city_root))
    assert all(os.path.exists(d["sem_seg_file_name"]) for d in sem)
    tcity.register_cityscapes(city_root)
    assert DatasetCatalog.get("cityscapes_fine_instance_seg_val") == ref
    assert MetadataCatalog.get("cityscapes_fine_sem_seg_val").ignore_label == 255
    assert DatasetCatalog.get("cityscapes_fine_instance_seg_test") == []


def city_predictions(dicts, seed, masks: bool):
    rng = np.random.RandomState(seed)
    inputs, outputs = [], []
    for d in dicts:
        boxes, classes, rles = [], [], []
        for a in d["annotations"]:
            m = rle.decode(a["segmentation"]).astype(bool)
            if rng.rand() < 0.8:
                # the instance, shifted by up to 2 px; sometimes the wrong class
                m = np.roll(m, tuple(rng.randint(-2, 3, 2)), axis=(0, 1))
                cls = a["category_id"] if rng.rand() < 0.85 else rng.randint(8)
                x, y, w, h = a["bbox"]
                boxes.append([x, y, x + w, y + h])
                classes.append(cls)
                rles.append(rle.encode(m.astype(np.uint8)))
        for _ in range(3):
            y0, y1 = sorted(rng.randint(0, d["height"], 2) + [0, 1])
            x0, x1 = sorted(rng.randint(0, d["width"], 2) + [0, 1])
            m = _box_mask(d["height"], d["width"], y0, x0, y1, x1)
            boxes.append([x0, y0, x1, y1])
            classes.append(rng.randint(8))
            rles.append(rle.encode(m.astype(np.uint8)))
        inst = {"boxes": np.array(boxes, float), "classes": np.array(classes),
                "scores": rng.rand(len(boxes))}
        if masks:
            inst["rles"] = rles
        inputs.append({"image_id": d["image_id"]})
        outputs.append({"instances": inst})
    return inputs, outputs


@pytest.mark.parametrize("masks", [True, False], ids=["official_masks", "boxes"])
def test_cityscapes_instance_evaluator_matches_jax(city_root, masks):
    dicts = jcity.load_cityscapes_instances(*city_dirs(city_root))
    inputs, outputs = city_predictions(dicts, 6, masks)
    res = []
    for mod in (tcity_eval, jcity_eval):
        ev = mod.CityscapesInstanceEvaluator(dicts)
        ev.reset()
        ev.process(inputs, outputs)
        res.append(ev.evaluate())
    same_metrics(*res)
    assert 0 < res[1]["cityscapes_instance"]["AP50"] <= 100


def test_cityscapes_sem_seg_evaluator_matches_jax():
    rng = np.random.RandomState(7)
    inputs, outputs = [], []
    for _ in range(3):
        gt = rng.randint(0, 19, (32, 48))
        gt[rng.rand(32, 48) < 0.1] = 255
        pred = np.where(rng.rand(32, 48) < 0.6, gt % 19, rng.randint(0, 19, (32, 48)))
        inputs.append({"sem_seg_gt": gt})
        outputs.append({"sem_seg": pred})
    res = []
    for mod in (tcity_eval, jcity_eval):
        ev = mod.CityscapesSemSegEvaluator()
        ev.reset()
        ev.process(inputs, outputs)
        res.append(ev.evaluate())
    same_metrics(*res)
    assert 0 < res[1]["cityscapes_sem_seg"]["mIoU"] < 100


def test_evaluate_instance_ap_matches_jax_on_random_masks():
    rng = np.random.RandomState(8)
    gts, preds = {}, {}
    for img in range(4):
        gts[img] = [{"mask": _box_mask(48, 64, *sorted(rng.randint(0, 48, 2)),
                                       *sorted(rng.randint(0, 64, 2))),
                     "class": int(rng.randint(3)), "ignore": bool(rng.rand() < 0.2)}
                    for _ in range(4)] + [{"mask": rng.rand(48, 64) < 0.02, "class": -1}]
        preds[img] = [{"mask": np.roll(g["mask"], int(rng.randint(-3, 4)), axis=1),
                       "class": g["class"], "score": float(rng.rand())}
                      for g in gts[img][:4]] + [
            {"mask": rng.rand(48, 64) < 0.1, "class": int(rng.randint(3)),
             "score": float(rng.rand())}]
    got = evaluate_instance_ap(gts, preds, 3, min_region_size=20)
    ref = jcity_ap.evaluate_instance_ap(gts, preds, 3, min_region_size=20)
    same_metrics(got, ref)


# ---------------------------------------------------------------------------
# The official protocol's hand-built cases (the JAX package's
# tests/evaluation/test_cityscapes_official.py), on the port
# ---------------------------------------------------------------------------

H, W = 64, 96


def test_perfect_match_gives_ap_1():
    m = _box_mask(H, W, 8, 8, 40, 40)
    res = evaluate_instance_ap({0: [{"mask": m, "class": 0}]},
                               {0: [{"mask": m.copy(), "class": 0, "score": 0.9}]},
                               num_classes=2, min_region_size=10)
    assert res["AP"] == 1.0 and res["AP50"] == 1.0
    assert np.isnan(res["per_class"][1])


def test_duplicate_match_keeps_high_confidence():
    m = _box_mask(H, W, 8, 8, 40, 40)
    res = evaluate_instance_ap({0: [{"mask": m, "class": 0}]},
                               {0: [{"mask": m.copy(), "class": 0, "score": 0.9},
                                    {"mask": m.copy(), "class": 0, "score": 0.6}]},
                               num_classes=1, min_region_size=10)
    assert res["AP50"] == 1.0
    res2 = evaluate_instance_ap({0: [{"mask": m, "class": 0}]},
                                {0: [{"mask": m.copy(), "class": 0, "score": 0.9},
                                     {"mask": _box_mask(H, W, 50, 50, 60, 90), "class": 0,
                                      "score": 0.95}]},
                                num_classes=1, min_region_size=10)
    assert res2["AP50"] < 1.0


def test_prediction_on_ignore_region_is_not_fp():
    gt = _box_mask(H, W, 8, 8, 40, 40)
    base = {0: [{"mask": gt, "class": 0},
                {"mask": _box_mask(H, W, 45, 45, 64, 96), "class": 0, "ignore": True}]}
    clean = {0: [{"mask": gt.copy(), "class": 0, "score": 0.9}]}
    crowd = {0: [{"mask": gt.copy(), "class": 0, "score": 0.9},
                 {"mask": _box_mask(H, W, 48, 48, 60, 80), "class": 0, "score": 0.95}]}
    r_clean = evaluate_instance_ap(base, clean, 1, min_region_size=10)
    r_crowd = evaluate_instance_ap(base, crowd, 1, min_region_size=10)
    assert r_crowd["AP50"] == r_clean["AP50"] == 1.0


def test_undersized_gt_excluded_and_absorbs_predictions():
    tiny = _box_mask(H, W, 0, 0, 5, 5)
    big = _box_mask(H, W, 8, 8, 40, 40)
    gts = {0: [{"mask": tiny, "class": 0}, {"mask": big, "class": 0}]}
    preds = {0: [{"mask": big.copy(), "class": 0, "score": 0.9},
                 {"mask": tiny.copy(), "class": 0, "score": 0.95}]}
    assert evaluate_instance_ap(gts, preds, 1, min_region_size=100)["AP50"] == 1.0


def test_hard_false_negative_caps_recall():
    g1 = _box_mask(H, W, 8, 8, 30, 30)
    g2 = _box_mask(H, W, 8, 50, 30, 80)
    res = evaluate_instance_ap({0: [{"mask": g1, "class": 0}, {"mask": g2, "class": 0}]},
                               {0: [{"mask": g1.copy(), "class": 0, "score": 0.9}]},
                               1, min_region_size=10)
    assert abs(res["AP50"] - 0.5) < 1e-9


def test_void_region_ignores_any_class():
    gt = _box_mask(H, W, 8, 8, 40, 40)
    gts = {0: [{"mask": gt, "class": 0},
               {"mask": _box_mask(H, W, 45, 45, 64, 96), "class": -1}]}
    preds = {0: [{"mask": gt.copy(), "class": 0, "score": 0.9},
                 {"mask": _box_mask(H, W, 48, 48, 62, 90), "class": 0, "score": 0.95}]}
    assert evaluate_instance_ap(gts, preds, 1, min_region_size=10)["AP50"] == 1.0


def test_gt_without_predictions_scores_zero():
    gt = _box_mask(H, W, 8, 8, 40, 40)
    res = evaluate_instance_ap({0: [{"mask": gt, "class": 0}]}, {0: []}, 1,
                               min_region_size=10)
    assert res["AP"] == 0.0


def test_partial_overlap_spans_thresholds():
    gt = _box_mask(H, W, 0, 0, 40, 40)
    pred = _box_mask(H, W, 0, 0, 40, 28)        # IoU = 0.7
    res = evaluate_instance_ap({0: [{"mask": gt, "class": 0}]},
                               {0: [{"mask": pred, "class": 0, "score": 0.9}]},
                               num_classes=1, min_region_size=10)
    assert res["AP50"] == 1.0
    n_pass = int(np.sum(np.arange(0.5, 1.0, 0.05) < (40 * 28) / (40 * 40) - 1e-9))
    assert abs(res["AP"] - n_pass / 10.0) < 1e-9


def test_instance_evaluator_end_to_end_official_path():
    gt = _box_mask(H, W, 8, 8, 40, 40)
    crowd = _box_mask(H, W, 45, 45, 64, 96)
    dataset_dicts = [{
        "image_id": 7, "height": H, "width": W,
        "annotations": [
            {"category_id": 0, "bbox": [8, 8, 32, 32], "area": int(gt.sum()),
             "iscrowd": 0, "segmentation": rle.encode(gt.astype(np.uint8))},
            {"category_id": 0, "bbox": [45, 45, 51, 19], "area": int(crowd.sum()),
             "iscrowd": 1, "segmentation": rle.encode(crowd.astype(np.uint8))},
        ],
    }]
    ev = tcity_eval.CityscapesInstanceEvaluator(dataset_dicts)
    ev.reset()
    in_crowd = _box_mask(H, W, 48, 48, 60, 80)
    ev.process([{"image_id": 7}], [{"instances": {
        "boxes": np.array([[8, 8, 40, 40], [48, 48, 80, 60]], float),
        "scores": np.array([0.9, 0.95]), "classes": np.array([0, 0]),
        "rles": [rle.encode(gt.astype(np.uint8)), rle.encode(in_crowd.astype(np.uint8))],
    }}])
    res = ev.evaluate()["cityscapes_instance"]
    assert res["AP50"] == 100.0 and res["AP"] == 100.0
    assert rle.encode(gt.astype(np.uint8)) == jrle.encode(gt.astype(np.uint8))
