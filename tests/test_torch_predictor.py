"""The eval path of u2seg_torch vs the JAX package's, on the CPU: the host
resize, ``detections_to_records``, and ``DefaultPredictor`` as a whole
(``__call__`` and ``run_batched`` in its three modes).

Both predictors run a tiny config (R50 depth, narrow widths, 7 classes, f32,
``pooler_impl="gather"``) on the same weights (a seeded, randomized port
model converted with the JAX package's ``convert_d2_panoptic_fpn``; the port
side loads it back through ``DefaultPredictor.from_jax``) and the same uint8
images, all of one bucket so that the JAX side compiles four programs only.

Tolerances. Resize: f32 rounding (rtol 1e-5, atol 2e-4 on values up to
255). Records: boxes and scores rtol 1e-4 with atol 1e-4 * max|ref|; validity
(record counts) and classes exact, as in the model test. Semantic and
panoptic maps, segment ids, kinds, categories and instance references exact;
stuff areas exact; per-instance pasted masks (host mode) may differ on < 1%
of their pixels: mask logits sit downstream of three cascade refinements
whose f32 rounding they amplify (the model test holds them per head instead).
With the resize on the device the network's input itself differs between the
frameworks by f32 rounding (two products summed in other orders), so a mask
pixel at the 0.5 threshold may flip: there the panoptic map may differ on
<= 0.1% of its pixels and a stuff area by as many pixels.
"""
import numpy as np
import pytest
import torch

from u2seg_tpu.config import config as jconfig
from u2seg_tpu.data import transforms as JT
from u2seg_tpu.engine import predictor as jpred
from u2seg_tpu.engine.checkpoint import convert_d2_panoptic_fpn
from u2seg_torch import config as tconfig
from u2seg_torch.data import transforms as T
from u2seg_torch.engine import predictor as tpred
from u2seg_torch.models.build import build_model

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# host geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,nh,nw", [
    (30, 44, 46, 67), (50, 40, 25, 20), (480, 640, 800, 1067), (37, 53, 37, 53)])
def test_resize_transform_matches_jax_on_float32(h, w, nh, nw):
    img = (np.random.RandomState(0).rand(h, w, 3) * 255).astype(np.uint8)
    img = img.astype(np.float32)
    ref = JT.ResizeTransform(h, w, nh, nw).apply_image(img)
    got = T.ResizeTransform(h, w, nh, nw).apply_image(img)
    assert got.shape == ref.shape == (nh, nw, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-4)


def test_resize_transform_takes_float_images_only():
    """Float images take the f32 bilinear resize (the predictor's path);
    uint8 images take OpenCV's fixed-point resize (the training mapper's,
    tests/test_torch_transforms_train.py); other types are refused."""
    img = np.zeros((4, 4, 3), np.float32)
    assert T.ResizeTransform(4, 4, 8, 8).apply_image(img).dtype == np.float32
    with pytest.raises(TypeError):
        T.ResizeTransform(4, 4, 8, 8).apply_image(np.zeros((4, 4, 3), np.int32))


@pytest.mark.parametrize("h,w", [(480, 640), (427, 640), (640, 480), (500, 375),
                                 (200, 1000), (1200, 900)])
def test_output_shape_and_buckets_match_jax(h, w):
    ref = JT.ResizeShortestEdge.get_output_shape(h, w, 800, 1333)
    assert T.ResizeShortestEdge.get_output_shape(h, w, 800, 1333) == ref
    buckets = ((800, 1344), (1344, 800), (1056, 1056))
    assert T.pick_bucket(*ref, buckets) == JT.pick_bucket(*ref, buckets)
    img = np.zeros((h, w, 3), np.float32)
    rng = np.random.RandomState(0)
    a = T.ResizeShortestEdge((800,), 1333).get_transform(img, rng)
    b = JT.ResizeShortestEdge((800,), 1333).get_transform(img, rng)
    assert (a.h, a.w, a.new_h, a.new_w) == (b.h, b.w, b.new_h, b.new_w)


def test_rle_codec_matches_jax():
    from u2seg_tpu.evaluation import rle as jrle
    from u2seg_torch.evaluation import rle

    rng = np.random.RandomState(0)
    for shape in ((17, 23), (1, 9), (8, 8)):
        mask = (rng.rand(*shape) > 0.6).astype(np.uint8)
        enc = rle.encode(mask)
        assert enc == jrle.encode(mask)
        np.testing.assert_array_equal(rle.decode(enc), mask)
        assert rle.area(enc) == int(mask.sum()) == jrle.area(enc)
        counts = rle.string_to_counts(enc["counts"])
        assert counts == jrle.string_to_counts(enc["counts"])
        assert rle.counts_to_string(counts) == enc["counts"]


def test_detections_to_records_matches_jax():
    rng = np.random.RandomState(3)
    k, m = 9, 14
    xy = rng.rand(k, 2) * [70, 40]
    boxes = np.concatenate([xy, xy + rng.rand(k, 2) * 40 + 4], 1).astype(np.float32)
    scores = rng.rand(k).astype(np.float32)
    classes = rng.randint(0, 7, k).astype(np.int32)
    valid = rng.rand(k) > 0.3
    logits = (rng.randn(k, m, m) * 4).astype(np.float32)
    args = (boxes, scores, classes, valid, logits, (64, 124), (36, 70))
    ref = jpred.detections_to_records(*args)
    got = tpred.detections_to_records(*args)
    assert sorted(got) == sorted(ref)
    np.testing.assert_array_equal(got["boxes"], ref["boxes"])
    np.testing.assert_array_equal(got["scores"], ref["scores"])
    np.testing.assert_array_equal(got["classes"], ref["classes"])
    assert got["rles"] == ref["rles"] and len(got["rles"]) == int(valid.sum())
    for a, b in zip(got["masks"], ref["masks"]):
        np.testing.assert_array_equal(a, b)
    assert "masks" not in tpred.detections_to_records(
        boxes, scores, classes, valid, None, (64, 124), (36, 70))


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

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
    # the canvas covers the originals; random weights give a near-worst-case
    # argmax map, so the budgets allow about one run per pixel
    cfg.test.render_canvas = (48, 80)
    cfg.test.render_max_runs = 4096
    cfg.test.fetch_runs_per_image = 2048
    cfg.test.raw_buckets = ((48, 80),)
    return cfg


def randomize(model, rng):
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith(("running_mean", ".bias")):
                v.copy_(torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.1))
            elif k.endswith(("running_var", "norm.weight")):
                v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
        # spread the mask logits so the 0.5 paste threshold is decisive
        model.roi_heads.mask_head.predictor.weight.mul_(300.0)
    return model


def to_numpy_tree(tree):
    return {k: to_numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def images():
    rs = np.random.RandomState(0)
    return [(rs.rand(h, w, 3) * 255).astype(np.uint8)
            for h, w in ((40, 80), (36, 70), (40, 72))]


@pytest.fixture(scope="module")
def predictors():
    cfg_t, cfg_j = tiny(tconfig.Config()), tiny(jconfig.Config())
    src = randomize(build_model(cfg_t, device="cpu"), np.random.RandomState(0))
    params, stats = convert_d2_panoptic_fpn(
        {k: v.numpy() for k, v in src.state_dict().items()})
    jp = jpred.DefaultPredictor(
        cfg_j, variables={"params": params, "batch_stats": stats})
    tp = tpred.DefaultPredictor.from_jax(
        cfg_t, to_numpy_tree(params), to_numpy_tree(stats), device="cpu")
    assert tp.device.type == "cpu"
    return jp, tp


def assert_same_result(got: dict, ref: dict, masks: bool, pan_tol: float = 0.0):
    gi, ri = got["instances"], ref["instances"]
    assert len(gi["scores"]) == len(ri["scores"]) > 0
    np.testing.assert_array_equal(gi["classes"], ri["classes"])
    for name in ("boxes", "scores"):
        np.testing.assert_allclose(
            gi[name], ri[name], rtol=1e-4,
            atol=1e-4 * float(np.abs(ri[name]).max()))
    assert ("masks" in gi) == ("masks" in ri) == masks
    if masks:
        for a, b in zip(gi["masks"], ri["masks"]):
            assert a.shape == b.shape and (a != b).mean() < 0.01
    assert got["sem_seg"].shape == ref["sem_seg"].shape
    np.testing.assert_array_equal(got["sem_seg"], ref["sem_seg"])
    flipped = int((got["panoptic"] != ref["panoptic"]).sum())
    assert flipped <= pan_tol * ref["panoptic"].size
    assert len(got["segments"]) == len(ref["segments"])
    for a, b in zip(got["segments"], ref["segments"]):
        assert sorted(a) == sorted(b)
        for key in ("id", "isthing", "category_id"):
            assert a[key] == b[key]
        if a["isthing"]:
            assert a["instance_id"] == b["instance_id"]
            np.testing.assert_allclose(a["score"], b["score"], rtol=1e-4)
        else:
            assert abs(a["area"] - b["area"]) <= flipped


def test_call_matches_jax(predictors):
    jp, tp = predictors
    img = images()[1]
    ref, got = jp(img), tp(img)
    assert_same_result(got, ref, masks=True)
    assert got["sem_seg"].shape == img.shape[:2]
    kinds = [s["isthing"] for s in got["segments"]]
    assert any(kinds) and not all(kinds)        # things and stuff were painted


MODES = {
    "host": dict(),
    "device_render": dict(device_render=True),
    "device_resize": dict(device_render=True, device_resize=True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_batched_matches_jax_and_call(predictors, mode):
    jp, tp = predictors
    imgs = images()
    before = dict(tp.fetch_stats)
    ref = dict(jp.run_batched(enumerate(imgs), batch_size=2, **MODES[mode]))
    got = dict(tp.run_batched(enumerate(imgs), batch_size=2, **MODES[mode]))
    assert sorted(got) == sorted(ref) == [0, 1, 2]
    for i in ref:
        assert_same_result(got[i], ref[i], masks=(mode == "host"),
                           pan_tol=1e-3 if mode == "device_resize" else 0.0)
        # batching, tail padding and the pipeline reorganise one computation
        assert_same_result(got[i], tp(imgs[i]) if mode == "host" else
                           {**tp(imgs[i]), "instances": got[i]["instances"]},
                           masks=(mode == "host"),
                           pan_tol=1e-3 if mode == "device_resize" else 0.0)
    fetched = tp.fetch_stats["fetches"] - before["fetches"]
    if mode == "host":
        assert fetched == 0
    else:
        # one copy per batch (2 batches), plus 2 for a batch whose runs
        # overflow the fetched prefix; no image took the fallback
        assert fetched in (2, 4, 6) and tp.fetch_stats.get("fallbacks", 0) == 0
        assert tp.fetch_stats["bytes"] > before["bytes"]


def test_image_larger_than_the_canvas_takes_the_host_fallback(predictors):
    _, tp = predictors
    big = (np.random.RandomState(5).rand(56, 112, 3) * 255).astype(np.uint8)
    before = tp.fetch_stats.get("fallbacks", 0)
    (_, got), = list(tp.run_batched([("big", big)], batch_size=2,
                                    device_render=True, device_resize=True))
    assert tp.fetch_stats["fallbacks"] == before + 1
    assert_same_result(got, tp(big), masks=True)


def test_predictor_refuses_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny(tconfig.Config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpred.DefaultPredictor(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpred.DefaultPredictor.from_jax(cfg, {}, {})
