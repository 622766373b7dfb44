"""DensePose data and evaluation of the port against the JAX package on the
CPU: annotation parsing (the part raster resized as OpenCV's nearest
resize), flip and packing; ``DensePoseDatasetMapper`` over the same files
and seeds, flip included; the COCO-DensePose json loader; the chart
quantisation (OpenCV's float bilinear resize on the JAX side); the RLE
helpers and ``DensePoseCOCOEvaluator`` on a synthetic set.

Tolerances: every array and record equal, with two exceptions. The mapper's
mask patches agree to 1e-5 (the port's f32 bilinear against OpenCV's on the
same 0/1 crop, as in ``test_torch_mapper.py``). The quantised U / V may
differ by one level of 255 where a value sits within f32 rounding of a
level (the resize matches OpenCV to f32 rounding), on at most 0.5% of the
pixels; the labels are equal.
"""
import json

import numpy as np
import pytest

from u2seg_tpu.config.config import Config as JConfig
from u2seg_tpu.evaluation import rle as jrle
from u2seg_tpu.projects import densepose_data as JDD
from u2seg_tpu.projects import densepose_eval as JDE
from u2seg_torch.config import Config
from u2seg_torch.data import transforms as T
from u2seg_torch.data.image_io import write_png
from u2seg_torch.projects import densepose_data as PDD
from u2seg_torch.projects import densepose_eval as PDE


def _ann(n_pts=5, seed=0, with_masks=True, bbox=(10.0, 20.0, 40.0, 80.0)):
    rng = np.random.RandomState(seed)
    ann = {"bbox": list(bbox), "iscrowd": 0, "category_id": 0,
           "dp_x": (rng.rand(n_pts) * 255).tolist(), "dp_y": (rng.rand(n_pts) * 255).tolist(),
           "dp_I": rng.randint(1, 25, n_pts).astype(float).tolist(),
           "dp_U": rng.uniform(-0.1, 1.1, n_pts).tolist(), "dp_V": rng.rand(n_pts).tolist()}
    if with_masks:
        masks = []
        for part in range(14):
            if part % 3 == 0:
                m = np.zeros((256, 256), np.uint8)
                m[part * 10:part * 10 + 60, 20 + part * 5:110 + part * 3] = 1
                masks.append(jrle.encode(m))
            else:
                masks.append([])
        ann["dp_masks"] = masks
    return ann


def _same_raw(got, ref):
    assert (got is None) == (ref is None)
    if ref is None:
        return
    for field in ("xy", "i", "u", "v", "point_valid", "segm"):
        g, r = getattr(got, field), getattr(ref, field)
        assert g.dtype == r.dtype and g.shape == r.shape, field
        np.testing.assert_array_equal(g, r, err_msg=field)


@pytest.mark.parametrize("segm_size,max_points", [(256, 8), (64, 196), (100, 3)])
def test_parse_flip_and_pack_match_jax(segm_size, max_points):
    anns = [_ann(5, 0), _ann(7, 1, with_masks=False), {"bbox": [0, 0, 5, 5]}, _ann(4, 2)]
    ref = [JDD.parse_densepose_annotation(a, max_points, segm_size) for a in anns]
    got = [PDD.parse_densepose_annotation(a, max_points, segm_size) for a in anns]
    for g, r in zip(got, ref):
        _same_raw(g, r)
        if r is not None:
            _same_raw(PDD.flip_densepose(g), JDD.flip_densepose(r))
    np.testing.assert_array_equal(PDD.decode_dp_masks(anns[0]["dp_masks"]),
                                  JDD.decode_dp_masks(anns[0]["dp_masks"]))
    whole = jrle.encode(np.pad(np.ones((10, 10), np.uint8), ((5, 241), (3, 243))))
    np.testing.assert_array_equal(PDD.decode_dp_masks(whole), JDD.decode_dp_masks(whole))
    rp = JDD.pack_densepose_gt(ref, 5, max_points, segm_size)
    gp = PDD.pack_densepose_gt(got, 5, max_points, segm_size)
    assert set(gp) == set(rp)
    for k in rp:
        assert gp[k].dtype == rp[k].dtype
        np.testing.assert_array_equal(gp[k], rp[k], err_msg=k)


def _small(cfg):
    cfg.model.max_gt_instances = 8
    cfg.input.pad_buckets = ((128, 128),)
    cfg.input.min_size_train = (96,)
    cfg.input.max_size_train = 128
    return cfg


def test_densepose_mapper_matches_jax_with_flip(tmp_path):
    h, w = 100, 120
    img = (np.random.RandomState(0).rand(h, w, 3) * 255).astype(np.uint8)
    fname = str(tmp_path / "img.png")
    write_png(fname, img)
    ann = _ann(n_pts=6, seed=3)
    ann["segmentation"] = [[10.0, 20.0, 50.0, 20.0, 50.0, 90.0, 10.0, 90.0]]
    other = {"bbox": [60.0, 10.0, 30.0, 40.0], "iscrowd": 0, "category_id": 0,
             "segmentation": [[60.0, 10.0, 90.0, 10.0, 90.0, 50.0, 60.0, 50.0]]}
    dd = {"file_name": fname, "image_id": 0, "height": h, "width": w,
          "annotations": [ann, other, dict(_ann(3, 4, bbox=(70.0, 55.0, 30.0, 30.0)),
                                          segmentation=[[70.0, 55.0, 100.0, 55.0, 100.0, 85.0,
                                                         70.0, 85.0]])]}
    jm = JDD.DensePoseDatasetMapper(_small(JConfig()), is_train=True, segm_size=64)
    pm = PDD.DensePoseDatasetMapper(_small(Config()), is_train=True, segm_size=64)
    flips = set()
    x_orig = np.asarray(ann["dp_x"], np.float32) / 256.0
    for seed in range(8):
        ref = jm(dd, np.random.RandomState(seed))
        got = pm(dd, np.random.RandomState(seed))
        assert set(got) == set(ref)
        for k, v in ref.items():
            if k == "gt_masks":
                np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5)
            elif isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v, k
        assert got["dp_valid"][:3].tolist() == [True, False, True]
        flips.add(bool(np.allclose(got["dp_xy"][0, :6, 0], 1.0 - x_orig)))
    assert flips == {True, False}
    off = PDD.DensePoseDatasetMapper(_small(Config()), is_train=True, densepose_hflip=False)
    assert any(isinstance(a, T.RandomFlip) for a in pm.augs.augs)
    assert not any(isinstance(a, T.RandomFlip) for a in off.augs.augs)


def test_load_densepose_coco_json_matches_jax(tmp_path):
    ann = _ann(4, 5)
    js = {"images": [{"id": 3, "file_name": "a.png", "height": 50, "width": 60}],
          "categories": [{"id": 1, "name": "person"}],
          "annotations": [dict(ann, id=1, image_id=3, category_id=1, area=100.0,
                               segmentation=[[1.0, 1.0, 20.0, 1.0, 20.0, 20.0]])]}
    path = tmp_path / "dp.json"
    path.write_text(json.dumps(js, default=bytes.decode))   # RLE counts
    ref = JDD.load_densepose_coco_json(str(path), str(tmp_path))
    got = PDD.load_densepose_coco_json(str(path), str(tmp_path))
    assert got == ref
    assert "dp_masks" in got[0]["annotations"][0]


@pytest.mark.parametrize("seed,box_wh", [(0, (37, 53)), (1, (112, 9)), (2, (200, 240))])
def test_quantize_chart_result_matches_jax(seed, box_wh):
    rng = np.random.RandomState(seed)
    s = 28
    args = (rng.randn(s, s, 2).astype(np.float32), rng.randn(s, s, 25).astype(np.float32),
            rng.uniform(-0.2, 1.2, (s, s, 25)).astype(np.float32),
            rng.rand(s, s, 25).astype(np.float32))
    ref = JDE.quantize_chart_result(*args, box_wh)
    got = PDE.quantize_chart_result(*args, box_wh)
    assert got.dtype == ref.dtype and got.shape == ref.shape == (3, box_wh[1], box_wh[0])
    np.testing.assert_array_equal(got[0], ref[0])
    diff = np.abs(got[1:].astype(np.int16) - ref[1:].astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.005, (diff.max(), (diff > 0).mean())


def test_rle_helpers_match_jax():
    rng = np.random.RandomState(6)
    mask = (rng.rand(30, 20) > 0.5).astype(np.uint8)
    for bbox in ([5, 7, 20, 30], [-4, -3, 20, 30], [45, 50, 20, 30]):
        assert PDE._rle_on_image(mask, 60, 50, bbox) == JDE._rle_on_image(mask, 60, 50, bbox)
    assert PDE._rle_on_image(None, 60, 50, [0, 0, 1, 1]) == JDE._rle_on_image(None, 60, 50, [0, 0, 1, 1])
    poly = {"bbox": [2.0, 3.0, 20.0, 30.0], "segmentation": [[2.0, 3.0, 22.0, 3.0, 22.0, 33.0]]}
    rle = {"bbox": [2.0, 3.0, 20.0, 30.0], "segmentation": jrle.encode(
        np.asfortranarray((rng.rand(60, 50) > 0.7).astype(np.uint8)))}
    for a in (_ann(3, 7), poly, rle, {"bbox": [1.0, 1.0, 5.0, 5.0]}):
        assert PDE._gt_mask_rle(a, 60, 50) == JDE._gt_mask_rle(a, 60, 50)


def _dataset():
    dicts = []
    for i in range(3):
        anns = []
        for k in range(2):
            m = np.zeros((256, 256), np.uint8)
            m[40 + 10 * i:200, 60:220 - 20 * k] = 1
            anns.append({"bbox": [20.0 + 60 * k, 30.0 + 5 * i, 50.0, 70.0], "iscrowd": 0,
                         "dp_masks": [jrle.encode(m)] + [[]] * 13, "dp_x": [128.0],
                         "dp_y": [128.0], "dp_I": [1.0], "dp_U": [0.5], "dp_V": [0.5]})
        anns.append({"bbox": [150.0, 60.0, 40.0, 40.0], "iscrowd": 0})   # no densepose: ignored
        dicts.append({"image_id": 100 + i, "height": 160, "width": 240, "annotations": anns})
    return dicts


def _predictions(rng, d, s=32, jitter=0.0):
    out = {"boxes": [], "scores": [], "coarse_segm": [], "fine_segm": [], "u": [], "v": []}
    for a in d["annotations"]:
        x, y, w, h = a["bbox"]
        out["boxes"].append([x + jitter * w, y + jitter * h, x + w + jitter * w, y + h + jitter * h])
        out["scores"].append(rng.rand())
        out["coarse_segm"].append(rng.randn(s, s, 2) + np.array([0.0, 0.8]))
        out["fine_segm"].append(rng.randn(s, s, 25))
        out["u"].append(rng.rand(s, s, 25))
        out["v"].append(rng.rand(s, s, 25))
    out = {k: np.asarray(v, np.float32) for k, v in out.items()}
    out["valid"] = np.array([True] * (len(d["annotations"]) - 1) + [False])
    return out


@pytest.mark.parametrize("jitter", [0.0, 0.3])
def test_densepose_evaluator_matches_jax(jitter):
    rng = np.random.RandomState(int(jitter * 10))
    dicts = _dataset()
    preds = [_predictions(rng, d, jitter=jitter) for d in dicts]
    evs = (JDE.DensePoseCOCOEvaluator(dicts), PDE.DensePoseCOCOEvaluator(dicts))
    for ev in evs:
        ev.reset()
        for d, p in zip(dicts, preds):
            ev.process([{"image_id": d["image_id"]}], [p])
    ref, got = (ev.evaluate() for ev in evs)
    assert set(got["densepose"]) == set(ref["densepose"]) and len(ref["densepose"]) == 10
    for k, v in ref["densepose"].items():
        np.testing.assert_allclose(got["densepose"][k], v, rtol=0, atol=1e-9, err_msg=k)
    assert PDE.DensePoseCOCOEvaluator(dicts).evaluate() == {"densepose": {}}
