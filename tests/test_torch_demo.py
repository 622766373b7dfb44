"""The port's demo (``u2seg_torch/demo``) against the JAX package's
(``demo/u2seg_demo.py``), on the CPU, at the tiny config of
``test_torch_predictor.py`` with the same weights on both sides (a seeded,
randomized port model converted by ``convert_d2_panoptic_fpn``).

Tolerances: records' boxes and scores rtol 1e-4 (atol 1e-4 * max|ref|),
classes and segment tables exact, pasted instance masks equal on > 99% of
their pixels, as in ``test_torch_predictor.py``; the panoptic maps may differ on <= 0.1% of their pixels (a pasted mask's pixel at
the 0.5 threshold flips with f32 rounding: the mask logits are scaled x300;
a few pixels of a frame). Drawn images equal on every pixel
outside the labels' text boxes grown by 1 px (a flipped pixel may move a
segment's centroid, the label's origin, by one) and outside the pixels where
the panoptic maps or an instance's pasted mask differ (``test_torch_visualizer.py`` holds the text and
the drawing on equal inputs). Track ids equal.

The JAX demo parses ``--confidence-threshold`` and never reads it: at 0.05
and at 0.9 it draws the same instances. The port's demo applies it to the ROI
heads' test threshold and the panoptic fusion's, as detectron2's setup_cfg
does, and drops them.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from u2seg_tpu.config import config as jconfig
from u2seg_tpu.engine import predictor as jpred
from u2seg_tpu.engine.checkpoint import convert_d2_panoptic_fpn
from u2seg_tpu.utils import tracking as jtracking
from u2seg_tpu.utils import visualizer as jvis
from u2seg_torch import config as tconfig
from u2seg_torch.demo import predictor as tdemo
from u2seg_torch.demo import u2seg_demo
from u2seg_torch.models.build import build_model

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny(cfg):
    m = cfg.model
    m.compute_dtype = "float32"
    m.resnet.width_per_group = 8
    m.resnet.stem_out_channels = 16
    m.resnet.res2_out_channels = 32
    m.fpn.out_channels = 32
    m.rpn.pre_nms_topk_test = 200
    m.rpn.post_nms_topk_test = 100
    m.roi_heads.num_classes = 7
    m.roi_heads.box_head.fc_dim = 64
    m.roi_heads.mask_head.conv_dim = 32
    m.roi_heads.detections_per_image = 20
    m.roi_heads.pooler_impl = "gather"
    m.sem_seg_head.conv_dim = 32
    m.sem_seg_head.num_classes = 5
    m.panoptic.instance_conf_thresh = 0.1
    m.panoptic.stuff_area_limit = 256
    cfg.input.min_size_test = 64
    cfg.input.max_size_test = 128
    cfg.input.pad_buckets = ((64, 128), (128, 64))
    return cfg


def randomize(model, rng):
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith(("running_mean", ".bias")):
                v.copy_(torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.1))
            elif k.endswith(("running_var", "norm.weight")):
                v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
        model.roi_heads.mask_head.predictor.weight.mul_(300.0)
    return model


def frames():
    rs = np.random.RandomState(0)
    base = (rs.rand(96, 192, 3) * 255).astype(np.uint8)
    # a "video": the same scene drifting by a pixel a frame
    return [np.ascontiguousarray(np.roll(base, t, axis=1)) for t in range(3)]


def load_jax_demo():
    spec = importlib.util.spec_from_file_location(
        "jax_u2seg_demo", os.path.join(ROOT, "demo", "u2seg_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    model = randomize(build_model(tiny(tconfig.Config()), device="cpu"),
                      np.random.RandomState(0))
    weights = str(tmp_path_factory.mktemp("w") / "model.pth")
    torch.save(model.state_dict(), weights)
    params, stats = convert_d2_panoptic_fpn(
        {k: v.numpy() for k, v in model.state_dict().items()})
    jp = jpred.DefaultPredictor(tiny(jconfig.Config()),
                                variables={"params": params, "batch_stats": stats})
    return model, weights, jp


@pytest.fixture
def jax_demo(setup, monkeypatch):
    """The JAX demo module, its predictor the prepared one (one compile)."""
    monkeypatch.setattr(jpred, "DefaultPredictor", lambda cfg: setup[2])
    return load_jax_demo()


def assert_same_predictions(got, ref):
    gi, ri = got["instances"], ref["instances"]
    assert len(gi["scores"]) == len(ri["scores"]) > 0
    np.testing.assert_array_equal(gi["classes"], ri["classes"])
    for name in ("boxes", "scores"):
        np.testing.assert_allclose(gi[name], ri[name], rtol=1e-4,
                                   atol=1e-4 * float(np.abs(ri[name]).max()))
    assert (got["panoptic"] != ref["panoptic"]).mean() <= 1e-3
    for a, b in zip(gi["masks"], ri["masks"]):
        assert (a != b).mean() < 0.01
    assert [(s["id"], s["isthing"], s["category_id"]) for s in got["segments"]] == \
        [(s["id"], s["isthing"], s["category_id"]) for s in ref["segments"]]


def assert_same_drawing(got, ref, text_boxes, got_pred=None, ref_pred=None):
    keep = np.ones(ref.shape[:2], bool)
    for x0, y0, x1, y1 in text_boxes:
        keep[max(y0 - 1, 0):max(y1 + 2, 0), max(x0 - 1, 0):max(x1 + 2, 0)] = False
    if got_pred is not None and "panoptic" in got_pred:
        keep &= got_pred["panoptic"] == ref_pred["panoptic"]
    if got_pred is not None:
        for a, b in zip(got_pred["instances"]["masks"], ref_pred["instances"]["masks"]):
            keep &= a == b
    assert got.shape == ref.shape and keep.mean() > 0.5
    np.testing.assert_array_equal(got[keep], ref[keep])


@pytest.mark.parametrize("mapped", [False, True])
def test_run_on_image_matches_the_jax_demo(setup, jax_demo, tmp_path, mapped):
    model, _, _ = setup
    matching = ""
    if mapped:
        matching = str(tmp_path)
        with open(tmp_path / "instance_mapping.json", "w") as f:
            json.dump({str(c): (c + 3) % 7 for c in range(7)}, f)
    jd = jax_demo.VisualizationDemo(tiny(jconfig.Config()), matching)
    td = tdemo.VisualizationDemo(tiny(tconfig.Config()), matching, device="cpu",
                                 model=model)
    assert (td.instance_mapping is None) == (not mapped)
    img = frames()[0]
    ref_pred, ref_img = jd.run_on_image(img)
    got_pred, got_img = td.run_on_image(img)
    assert_same_predictions(got_pred, ref_pred)
    assert sum(s["isthing"] for s in got_pred["segments"]) > 0
    assert_same_drawing(got_img, ref_img, td.text_boxes, got_pred, ref_pred)


def test_video_loop_tracks_and_draws_as_the_jax_demo(setup, jax_demo):
    model, _, jp = setup
    jd = jax_demo.VisualizationDemo(tiny(jconfig.Config()))
    tracker, vvis = jtracking.BBoxIOUTracker(), jvis.VideoVisualizer()
    td = tdemo.VisualizationDemo(tiny(tconfig.Config()), device="cpu", model=model)
    carried = 0
    for rgb, (pred, ids, drawn) in zip(frames(), td.run_on_video(frames())):
        ref_pred, _ = jd.run_on_image(rgb)
        ref_ids = tracker.update(ref_pred["instances"])
        ref = vvis.draw_instance_predictions(rgb, ref_pred["instances"], ref_ids)
        assert_same_predictions(pred, ref_pred)
        np.testing.assert_array_equal(ids, ref_ids)
        assert_same_drawing(drawn, ref, td.text_boxes, pred, ref_pred)
        carried += int((ids < len(ids)).sum())
    assert carried > 0


def test_async_predictor_returns_results_in_order(setup):
    model, _, _ = setup
    ap = tdemo.AsyncPredictor(tiny(tconfig.Config()), device="cpu", model=model)
    try:
        imgs = frames()
        for im in imgs:
            ap.put(im)
        assert len(ap) == 3
        direct = tdemo.VisualizationDemo(tiny(tconfig.Config()), device="cpu", model=model)
        for im in imgs:
            assert_same_predictions(ap.get(), direct.predictor(im))
    finally:
        ap.shutdown()


def _write_png(path, img):
    from u2seg_torch.data.image_io import write_png

    write_png(str(path), img)


def test_the_confidence_threshold_is_applied_where_the_jax_demo_ignores_it(
        setup, jax_demo, tmp_path, monkeypatch):
    import cv2

    from u2seg_tpu.config import config as jconfig_mod

    model, weights, _ = setup
    img_path = tmp_path / "scene.png"
    _write_png(img_path, frames()[0])

    monkeypatch.setattr(jconfig_mod, "load_config", lambda *a, **k: tiny(jconfig.Config()))
    jax_out = {}
    for thresh in ("0.05", "0.9"):
        out = tmp_path / f"jax_{thresh}"
        monkeypatch.setattr("sys.argv", ["u2seg_demo.py", "--config-file", "",
                                         "--input", str(img_path), "--output", str(out),
                                         "--confidence-threshold", thresh])
        jax_demo.main()
        jax_out[thresh] = cv2.imread(str(out / "scene.png"))
    np.testing.assert_array_equal(jax_out["0.05"], jax_out["0.9"])    # flag ignored

    def tiny_port(*a, **k):
        cfg = tiny(tconfig.Config())
        cfg.model.weights = weights
        return cfg

    monkeypatch.setattr(tconfig, "load_config", tiny_port)
    port = {}
    for thresh in ("0.05", "0.9"):
        out = tmp_path / f"port_{thresh}"
        (_, pred, vis), = u2seg_demo.main(
            ["--config-file", "", "--input", str(img_path), "--output", str(out),
             "--confidence-threshold", thresh, "--device", "cpu"])
        assert (out / "scene.png").exists()
        port[thresh] = pred
    low, high = port["0.05"]["instances"]["scores"], port["0.9"]["instances"]["scores"]
    assert len(low) > 0 and (low >= 0.05).all() and (low < 0.9).all()
    assert len(high) == 0                                  # every instance dropped
    assert not any(s["isthing"] for s in port["0.9"]["segments"])
    assert any(s["isthing"] for s in port["0.05"]["segments"])


def test_video_options_name_the_missing_decoder(monkeypatch):
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == u2seg_demo.VIDEO_MODULE
                        else real(name, *a))
    with pytest.raises(ImportError, match="OpenCV"):
        u2seg_demo.video_module()
