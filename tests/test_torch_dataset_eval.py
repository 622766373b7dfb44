"""``run_panoptic_evaluation`` of the port against the JAX package's, on the
same synthetic COCO-format set (``u2seg_torch.testing.write_synthetic_coco``,
registered in both packages' catalogs as ``tests/engine/test_eval_pipeline.py``
registers its own), on the CPU.

1. A stub predictor that answers with the ground truth in cluster space
   (``testing.OraclePredictor``), in every mode: the result dicts and the
   mapping files are equal exactly, and the oracle scores AP = PQ = 100.
2. The order of the outputs: images of both buckets interleaved in the
   sampler's order come back grouped by bucket; the results do not change.
3. The tiny model (R50 depth, narrow widths, f32, ``pooler_impl="gather"``)
   on the same weights in both packages, host render and device render, the
   modes in which ``tests/test_torch_predictor.py`` holds the maps
   pixel-equal: the metric dicts agree to 1e-6.
4. More than one process: each rank scores its own shard and nothing gathers
   the shards, in the port as in the JAX package (detectron2 gathers them):
   a rank's box AP counts the other ranks' images as missed.
"""
import os

import numpy as np
import pytest
import torch

from u2seg_tpu.config import config as jconfig
from u2seg_tpu.data import builtin as jbuiltin
from u2seg_tpu.data import catalog as jcatalog
from u2seg_tpu.data import coco as jcoco
from u2seg_tpu.engine import predictor as jpred
from u2seg_tpu.engine.checkpoint import convert_d2_panoptic_fpn
from u2seg_torch import config as tconfig
from u2seg_torch.data import builtin as tbuiltin
from u2seg_torch.engine import predictor as tpred
from u2seg_torch.models.build import build_model
from u2seg_torch.parallel import comm
from u2seg_torch.testing import (
    OraclePredictor, register_synthetic_coco, write_synthetic_coco,
)

torch.set_num_threads(1)

NAME = "synthetic_eval_case"
SIZES = [(48, 64), (64, 48), (40, 60), (50, 38), (60, 80), (38, 50)]


def register_jax(name, ds):
    if name in jcatalog.DatasetCatalog:
        jcatalog.DatasetCatalog.remove(name)
    jcatalog.DatasetCatalog.register(name, lambda: jcoco.merge_to_panoptic(
        jcoco.load_coco_json(ds.instances_json, ds.image_dir, name),
        jcoco.load_sem_seg(ds.sem_seg_dir, ds.image_dir, image_ext="png")))
    jcatalog.MetadataCatalog.get(name).set(
        json_file=ds.instances_json, panoptic_json=ds.panoptic_json,
        panoptic_root=ds.panoptic_dir)


@pytest.fixture
def both(tmp_path, monkeypatch):
    """Registers a set under NAME in both catalogs; the JAX driver writes its
    mappings into ./hungarian_matching, so it runs in its own directory."""
    def make(sizes, seed=0):
        ds = write_synthetic_coco(str(tmp_path / "coco"), sizes, np.random.RandomState(seed))
        register_synthetic_coco(NAME, ds)
        register_jax(NAME, ds)
        os.makedirs(tmp_path / "jax", exist_ok=True)
        monkeypatch.chdir(tmp_path / "jax")
        # the builtin names are registered once per process, not per case
        monkeypatch.setattr(tbuiltin, "register_all_coco", lambda *a, **k: None)
        monkeypatch.setattr(jbuiltin, "register_all_coco", lambda *a, **k: None)
        return ds
    yield make
    from u2seg_torch.data import catalog as tcatalog
    for mod in (tcatalog, jcatalog):
        if NAME in mod.DatasetCatalog:
            mod.DatasetCatalog.remove(NAME)


def configs(**test):
    out = []
    for mod in (tconfig, jconfig):
        cfg = mod.Config()
        cfg.datasets.test = (NAME,)
        cfg.dataloader.num_workers = 2
        for k, v in test.items():
            setattr(cfg.test, k, v)
        out.append(cfg)
    return out


def run_both(cfg_t, cfg_j, mode, port_pred, jax_pred, mdir, monkeypatch):
    monkeypatch.setattr(tpred, "DefaultPredictor", lambda cfg, device=None: port_pred)
    monkeypatch.setattr(jpred, "DefaultPredictor", lambda cfg: jax_pred)
    got = tpred.run_panoptic_evaluation(cfg_t, mode, device="cpu", matching_dir=mdir)[NAME]
    ref = jpred.run_panoptic_evaluation(cfg_j, mode)[NAME]
    return got, ref


def assert_same(a, b, tol=0.0):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (sorted(a), sorted(b))
        for k in a:
            assert_same(a[k], b[k], tol)
    elif isinstance(a, str):
        assert a == b
    else:
        assert np.isnan(a) == np.isnan(b) and (np.isnan(a) or abs(a - b) <= tol), (a, b)


def renamed(d, old, new):
    if isinstance(d, dict):
        return {k: renamed(v, old, new) for k, v in d.items()}
    return d.replace(old, new) if isinstance(d, str) else d


def mapping_bytes(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in ("instance_mapping.json", "semantic_mapping.json")
            if os.path.exists(os.path.join(d, f))}


# ---------------------------------------------------------------------------
# 1-2. the stub predictor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("modes", [("auto",), ("hungarian_matching", "eval")])
def test_oracle_through_both_drivers(both, tmp_path, monkeypatch, modes):
    both(SIZES)
    cfg_t, cfg_j = configs(ims_per_batch=2)
    mdir = str(tmp_path / "port" / "hungarian_matching")
    for mode in modes:
        got, ref = run_both(cfg_t, cfg_j, mode, OraclePredictor(800),
                            OraclePredictor(800), mdir, monkeypatch)
        assert_same(renamed(got, mdir, "./hungarian_matching"), ref)
    assert got["bbox"]["AP"] == pytest.approx(100.0, abs=1e-6)
    assert got["panoptic_seg"]["PQ"] == pytest.approx(100.0, abs=1e-4)
    assert got["sem_seg"]["mIoU"] > 99.0
    files = mapping_bytes(mdir)
    assert len(files) == 2 and files == mapping_bytes(str(tmp_path / "jax" / "hungarian_matching"))


def test_supervised_mode_scores_where_the_jax_driver_raises(both, tmp_path, monkeypatch):
    """The JAX driver hands the panoptic evaluator mode="supervised" without
    its ``supervised`` flag, so it looks for cluster mappings that a
    supervised run never writes; the port passes the flag."""
    both(SIZES)
    cfg_t, cfg_j = configs(ims_per_batch=2)
    mdir = str(tmp_path / "port" / "hungarian_matching")
    oracle = OraclePredictor(800, supervised=True)
    with pytest.raises(FileNotFoundError, match="instance_mapping.json"):
        run_both(cfg_t, cfg_j, "supervised", oracle, oracle, mdir, monkeypatch)
    got = tpred.run_panoptic_evaluation(cfg_t, "supervised", device="cpu",
                                        matching_dir=mdir)[NAME]
    assert sorted(got) == ["bbox", "panoptic_seg", "sem_seg"]
    assert got["panoptic_seg"]["PQ"] == pytest.approx(100.0, abs=1e-4)
    assert got["sem_seg"]["mIoU"] == pytest.approx(100.0)
    assert not os.path.exists(mdir)


class InOrder:
    """The oracle's answers in the sampler's order, one image at a time."""

    def __init__(self, cluster_num):
        self.oracle = OraclePredictor(cluster_num)

    def run_batched(self, examples, **_):
        for inp, _img in examples:
            yield inp, self.oracle.answer(inp)


def test_bucket_grouped_order_does_not_change_the_results(both, tmp_path, monkeypatch):
    ds = both(SIZES)
    cfg_t, _ = configs(ims_per_batch=2)
    order = []

    class Grouped(OraclePredictor):
        def run_batched(self, examples, **kw):
            for inp, out in super().run_batched(examples, **kw):
                order.append(inp["image_id"])
                yield inp, out

    res = {}
    for tag, pred in (("grouped", Grouped(800)), ("in_order", InOrder(800))):
        monkeypatch.setattr(tpred, "DefaultPredictor", lambda cfg, device=None: pred)
        res[tag] = tpred.run_panoptic_evaluation(
            cfg_t, "auto", device="cpu", matching_dir=str(tmp_path / tag))[NAME]
    wide = [i for i, (h, w) in zip(ds.image_ids, SIZES) if h <= w]
    assert order != sorted(order) and order[:2] == wide[:2]      # regrouped
    assert_same(res["grouped"], res["in_order"])


# ---------------------------------------------------------------------------
# 3. the tiny model on both packages
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
    cfg.test.render_canvas = (48, 80)
    cfg.test.render_max_runs = 4096
    cfg.test.fetch_runs_per_image = 2048
    cfg.test.raw_buckets = ((48, 80),)
    cfg.test.device_resize = False
    cfg.test.ims_per_batch = 2
    return cfg


def randomize(model, rng):
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith(("running_mean", ".bias")):
                v.copy_(torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.1))
            elif k.endswith(("running_var", "norm.weight")):
                v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
        model.roi_heads.mask_head.predictor.weight.mul_(300.0)
        for m in model.roi_heads.box_predictor:   # a wider spread of scores
            m.cls_score.weight.mul_(4.0)
    return model


def to_numpy_tree(tree):
    return {k: to_numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def predictors():
    cfg_t, cfg_j = tiny(tconfig.Config()), tiny(jconfig.Config())
    src = randomize(build_model(cfg_t, device="cpu"), np.random.RandomState(0))
    params, stats = convert_d2_panoptic_fpn(
        {k: v.numpy() for k, v in src.state_dict().items()})
    jp = jpred.DefaultPredictor(cfg_j, variables={"params": params, "batch_stats": stats})
    tp = tpred.DefaultPredictor.from_jax(
        cfg_t, to_numpy_tree(params), to_numpy_tree(stats), device="cpu")
    return tp, jp


@pytest.mark.parametrize("device_render,mode", [(False, "auto"), (True, "auto"),
                                               (False, "supervised")])
def test_tiny_model_metrics_match_jax(both, predictors, tmp_path, monkeypatch,
                                      device_render, mode):
    """In ``auto`` mode no detection of the tiny model passes the protocol's
    score 0.6 and box IoU 0.7, so every box is dropped and no ``bbox`` key is
    reported (in both packages); the supervised case, without panoptic GT,
    holds COCOeval on the model's boxes."""
    both([(40, 80), (36, 70), (40, 72), (38, 64)], seed=1)
    tp, jp = predictors
    for p in (tp, jp):
        p.cfg.datasets.test = (NAME,)
        p.cfg.test.device_render = device_render
    if mode == "supervised":
        from u2seg_torch.data import catalog as tcatalog
        for cat in (tcatalog, jcatalog):
            cat.MetadataCatalog.get(NAME).set(panoptic_json=None)
    mdir = str(tmp_path / "port" / "hungarian_matching")
    got, ref = run_both(tp.cfg, jp.cfg, mode, tp, jp, mdir, monkeypatch)
    assert sorted(got) == sorted(ref)
    assert sorted(got) == (["bbox", "sem_seg"] if mode == "supervised"
                           else ["panoptic_seg", "sem_seg"])
    assert_same(got, ref, tol=1e-6)
    assert mapping_bytes(mdir) == mapping_bytes(str(tmp_path / "jax" / "hungarian_matching"))


# ---------------------------------------------------------------------------
# 4. each rank scores its own shard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank", [0, 1])
def test_ranks_score_their_shard_and_nothing_gathers(both, tmp_path, monkeypatch, rank):
    import jax

    both(SIZES)
    cfg_t, cfg_j = configs(ims_per_batch=2)
    seen = []

    class Seen(InOrder):
        def run_batched(self, examples, **kw):
            for inp, out in super().run_batched(examples, **kw):
                seen.append(inp["image_id"])
                yield inp, out

    monkeypatch.setattr(tpred, "DefaultPredictor", lambda cfg, device=None: InOrder(800))
    full = tpred.run_panoptic_evaluation(
        cfg_t, "auto", device="cpu", matching_dir=str(tmp_path / "full"))[NAME]
    monkeypatch.setattr(comm, "get_rank", lambda: rank)
    monkeypatch.setattr(comm, "get_world_size", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    mdir = str(tmp_path / "port" / "hungarian_matching")
    got, ref = run_both(cfg_t, cfg_j, "auto", Seen(800), InOrder(800), mdir, monkeypatch)
    assert_same(got, ref)
    n = len(SIZES) // 2
    ids = sorted(seen)
    assert len(ids) == n and ids == sorted(
        sorted({100 + 7 * i for i in range(len(SIZES))})[rank * n:(rank + 1) * n])
    # nothing gathers: COCOeval holds this rank's detections against the GT
    # of every image, so the other shard's boxes count as missed
    assert full["bbox"]["AP"] == pytest.approx(100.0, abs=1e-6)
    assert got["bbox"]["AP"] < 90.0
    assert got["panoptic_seg"]["PQ"] == pytest.approx(100.0, abs=1e-4)
