"""The port's ``DatasetMapper`` (``u2seg_torch/data/mapper.py``) against the
JAX package's, in both modes, on a U2Seg training set written by
``u2seg_torch.testing.write_synthetic_u2seg_train`` (JPEG scenes, CutLER RLE
and polygon instances, one crowd region, one image over ``max_gt``, STEGO
stuff maps), registered in both packages by their ``register_all_coco``.

Tolerance: the image and every integer key (boxes aside, which are f32 and
equal too) are equal; the mask patches agree to 1e-5 (the port's f32
bilinear against OpenCV's float resize of the same 0/1 crop). The polygon
instances come from ``polygons_to_bitmask``; the synthetic polygons cross
the border, where the port's rasteriser differs from OpenCV's on a few
pixels (``tests/test_torch_masks.py``), so a patch is compared only where
the full masks of both packages agree.
"""
import copy

import numpy as np
import pytest

from u2seg_tpu.config.config import Config as JConfig
from u2seg_tpu.data import builtin as jbuiltin
from u2seg_tpu.data import mapper as jmapper
from u2seg_tpu.data.catalog import DatasetCatalog as JCatalog
from u2seg_torch.config import Config
from u2seg_torch.data import builtin, mapper
from u2seg_torch.data.catalog import DatasetCatalog
from u2seg_torch.testing import write_synthetic_u2seg_train

CLUSTERS = 37
SMALL = [(120, 160), (96, 128), (160, 120), (100, 75), (150, 200)]


def _small(cfg):
    cfg.input.min_size_train = (64, 96, 128, 160, 192)
    cfg.input.max_size_train = 256
    cfg.input.min_size_test = 128
    cfg.input.max_size_test = 200
    cfg.input.pad_buckets = ((160, 256), (256, 160), (200, 200))
    return cfg


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("u2seg"))
    ds = write_synthetic_u2seg_train(root, SMALL, CLUSTERS, seed=3)
    builtin.register_all_coco(root, cluster_num=CLUSTERS)
    jbuiltin.register_all_coco(root, cluster_num=CLUSTERS)
    dicts = DatasetCatalog.get(ds.dataset)
    assert dicts == JCatalog.get(ds.dataset)
    return ds, dicts


def _mask_agreement(dd, h, w):
    """Per annotation: whether both packages rasterise it identically."""
    same = []
    for a in dd["annotations"]:
        if a.get("iscrowd", 0):
            continue
        same.append(np.array_equal(mapper.segmentation_to_mask(a["segmentation"], h, w),
                                   jmapper.segmentation_to_mask(a["segmentation"], h, w)))
    return same


def _same_example(got, ref, same_masks=None):
    if ref is None:
        assert got is None
        return
    assert got is not None and set(got) == set(ref)
    for k, v in ref.items():
        g = got[k]
        if k == "gt_masks":
            valid = ref["gt_valid"]
            rows = np.ones(len(v), bool)
            if same_masks is not None:
                idx = ref["gt_ann_index"]
                rows = np.array([i < 0 or same_masks[i] for i in idx])
            np.testing.assert_allclose(g[rows & valid], v[rows & valid], rtol=0, atol=1e-5)
            assert not g[~valid].any()
            assert g.min() >= 0 and g.max() <= 1
        elif isinstance(v, np.ndarray):
            assert g.dtype == v.dtype and g.shape == v.shape, k
            np.testing.assert_array_equal(g, v, err_msg=k)
        else:
            assert g == v, k


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("recipe", ["default", "crop", "color"])
def test_mapper_matches_jax(dataset, is_train, recipe):
    ds, dicts = dataset
    cfg, jcfg = _small(Config()), _small(JConfig())
    for c in (cfg, jcfg):
        if recipe == "crop":
            c.input.crop_enabled, c.input.crop_size = True, (0.5, 0.5)
            c.input.crop_single_category_max_area = 0.7
        if recipe == "color":
            c.input.color_aug = True
    m, jm = mapper.DatasetMapper(cfg, is_train), jmapper.DatasetMapper(jcfg, is_train)
    kept = 0
    for seed in range(3):
        for dd in dicts:
            same = _mask_agreement(dd, dd["height"], dd["width"])
            got = m(dd, np.random.RandomState(seed))
            ref = jm(dd, np.random.RandomState(seed))
            _same_example(got, ref, same)
            kept += ref is not None and int(ref["gt_valid"].sum())
            if ref is not None:
                h, w = ref["image_size"]
                b = ref["gt_boxes"][ref["gt_valid"]]
                assert (b[:, 0] >= 0).all() and (b[:, 2] <= w).all() and (b[:, 3] <= h).all()
    assert kept > 50


@pytest.mark.parametrize("expand", [True, False])
def test_rotation_recipe_matches_jax_but_bounds_the_rotated_corners(dataset, expand):
    """``input.rotation_enabled``: the image, its size and the sem-seg map
    equal the JAX mapper's (the warp is OpenCV's bit for bit); a box is the
    bounding box of its four rotated corners, so it holds the JAX mapper's
    two-corner box of the same annotation (ROADMAP.md section 3)."""
    ds, dicts = dataset
    cfg, jcfg = _small(Config()), _small(JConfig())
    for c in (cfg, jcfg):
        c.input.rotation_enabled, c.input.rotation_expand = True, expand
    m, jm = mapper.DatasetMapper(cfg, True), jmapper.DatasetMapper(jcfg, True)
    compared = wider = 0
    for seed in range(3):
        for dd in dicts:
            got = m(dd, np.random.RandomState(seed))
            ref = jm(dd, np.random.RandomState(seed))
            if ref is None or got is None:
                continue
            for k in ("image", "image_size", "sem_seg", "bucket"):
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            h, w = got["image_size"]
            b = got["gt_boxes"][got["gt_valid"]]
            assert (b[:, :2] >= 0).all() and (b[:, 2] <= w).all() and (b[:, 3] <= h).all()
            mine = dict(zip(got["gt_ann_index"][got["gt_valid"]], b))
            for i, rb in zip(ref["gt_ann_index"][ref["gt_valid"]], ref["gt_boxes"][ref["gt_valid"]]):
                if i in mine:
                    assert (mine[i][:2] <= rb[:2] + 1e-4).all() and (mine[i][2:] >= rb[2:] - 1e-4).all()
                    compared += 1
                    wider += bool((mine[i][2:] - mine[i][:2] > rb[2:] - rb[:2] + 1e-3).any())
    assert compared > 30 and wider > 0


def test_full_recipe_at_coco_sizes_with_off_bucket_rescale(dataset, tmp_path):
    """The default Config() on two COCO-size images: shortest edges up to
    1024 with a cap of 1333, so some draws miss every bucket and are
    resized a second time (uint8 resize, then the off-bucket rescale)."""
    ds = write_synthetic_u2seg_train(str(tmp_path), [(480, 640), (500, 375)], 11, seed=5)
    from u2seg_torch.data.coco import load_coco_json, load_sem_seg, merge_to_panoptic

    dicts = merge_to_panoptic(load_coco_json(ds.instances_json, ds.image_dir),
                              load_sem_seg(ds.sem_seg_dir, ds.image_dir))
    m, jm = mapper.DatasetMapper(Config(), True), jmapper.DatasetMapper(JConfig(), True)
    rescaled = 0
    for seed in (0, 2, 4, 6):               # seed 6 draws 1024
        for dd in dicts:
            same = _mask_agreement(dd, dd["height"], dd["width"])
            got = m(dd, np.random.RandomState(seed))
            ref = jm(dd, np.random.RandomState(seed))
            _same_example(got, ref, same)
            rescaled += bool(1056 in ref["image_size"])      # scaled into (1056, 1056)
    assert rescaled >= 1


def test_none_exactly_where_jax_returns_none(dataset):
    ds, dicts = dataset
    cfg, jcfg = _small(Config()), _small(JConfig())
    m, jm = mapper.DatasetMapper(cfg, True), jmapper.DatasetMapper(jcfg, True)
    cases = []
    dd = copy.deepcopy(dicts[1])
    for a in dd["annotations"]:                    # boxes off the image
        a["bbox"] = [dd["width"] + 5.0, 2.0, 4.0, 4.0]
    cases.append((dd, True))
    dd = copy.deepcopy(dicts[1])
    for a in dd["annotations"]:                    # no segmentation while masks are on
        a.pop("segmentation")
    cases.append((dd, True))
    dd = copy.deepcopy(dicts[1])
    for a in dd["annotations"]:                    # crowd only: kept, with no instance
        a["iscrowd"] = 1
    cases.append((dd, False))
    dd = copy.deepcopy(dicts[1])
    dd["annotations"] = []                         # no annotation at all
    cases.append((dd, False))
    for dd, none in cases:
        got, ref = m(dd, np.random.RandomState(0)), jm(dd, np.random.RandomState(0))
        assert (ref is None) == none
        _same_example(got, ref)


def test_truncation_at_max_gt(dataset, caplog):
    ds, dicts = dataset
    dd = next(d for d in dicts if d["image_id"] == ds.crowded_image_id)
    cfg, jcfg = _small(Config()), _small(JConfig())
    assert len(dd["annotations"]) > cfg.model.max_gt_instances
    got = mapper.DatasetMapper(cfg, True)(dd, np.random.RandomState(1))
    ref = jmapper.DatasetMapper(jcfg, True)(dd, np.random.RandomState(1))
    _same_example(got, ref, _mask_agreement(dd, dd["height"], dd["width"]))
    assert got["gt_valid"].sum() == cfg.model.max_gt_instances
    assert "truncating" in caplog.text


def test_keypoints_follow_the_flip(dataset):
    ds, dicts = dataset
    cfg, jcfg = _small(Config()), _small(JConfig())
    cfg.model.keypoint_on = jcfg.model.keypoint_on = True
    dd = copy.deepcopy(dicts[0])
    rng = np.random.RandomState(4)
    for a in dd["annotations"]:
        x, y, w, h = a["bbox"]
        kp = np.stack([x + rng.rand(17) * w * 1.2, y + rng.rand(17) * h,
                       rng.randint(0, 3, 17)], 1)
        a["keypoints"] = kp.reshape(-1).tolist()
    m, jm = mapper.DatasetMapper(cfg, True), jmapper.DatasetMapper(jcfg, True)
    image = mapper.read_image(dd["file_name"])
    flips = 0
    for seed in range(6):
        got, ref = m(dd, np.random.RandomState(seed)), jm(dd, np.random.RandomState(seed))
        _same_example(got, ref, _mask_agreement(dd, dd["height"], dd["width"]))
        assert ref["gt_keypoints"][ref["gt_valid"]][..., 2].any()
        tfm = m.augs.get_transform(image, np.random.RandomState(seed))
        flips += mapper._count_hflips(tfm)
    assert 0 < flips < 6


def test_segmentation_to_mask_kinds(dataset):
    ds, dicts = dataset
    kinds = {type(a["segmentation"]).__name__ for d in dicts for a in d["annotations"]}
    assert kinds == {"dict", "list"}             # CutLER RLE and polygons
    arr = np.random.RandomState(0).rand(5, 6) > 0.5
    np.testing.assert_array_equal(mapper.segmentation_to_mask(arr, 5, 6),
                                  jmapper.segmentation_to_mask(arr, 5, 6))
    with pytest.raises(TypeError):
        mapper.segmentation_to_mask(3.0, 5, 6)
