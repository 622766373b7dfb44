"""The port's dataset layer (``u2seg_torch/data/{catalog,builtin_meta,coco,
builtin,loader}.py``) against the JAX package's, on the same inputs. Every
comparison is equality: these modules compute no floating point.

The synthetic COCO-format set is the one ``chip_smoke.py`` evaluates on
(``u2seg_torch.testing.write_synthetic_coco``), written through
``u2seg_torch.data.image_io`` and read here by both packages.
"""
import numpy as np
import pytest

from u2seg_tpu.data import builtin as jbuiltin
from u2seg_tpu.data import builtin_meta as jmeta
from u2seg_tpu.data import catalog as jcatalog
from u2seg_tpu.data import coco as jcoco
from u2seg_tpu.data import loader as jloader
from u2seg_torch.data import builtin, builtin_meta, catalog, coco, loader
from u2seg_torch.testing import write_synthetic_coco


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    return write_synthetic_coco(root, [(48, 64), (40, 60), (64, 48), (50, 38)],
                                np.random.RandomState(0))


def test_catalogs_behave_alike():
    for mod in (catalog, jcatalog):
        reg = mod._DatasetCatalog()
        reg.register("b", lambda: [{"x": 1}])
        reg.register("a", lambda: [])
        assert reg.list() == ["a", "b"] and "a" in reg and reg.get("b") == [{"x": 1}]
        with pytest.raises(KeyError, match="already registered"):
            reg.register("a", lambda: [])
        with pytest.raises(KeyError, match="not registered"):
            reg.get("c")
        reg.remove("a")
        assert reg.list() == ["b"]
        meta = mod._MetadataCatalog()
        m = meta.get("x").set(thing_classes=["p"], json_file="j")
        assert meta.get("x") is m and m.get("json_file") == "j"
        assert m.get("missing", 3) == 3 and m.as_dict()["name"] == "x"


def test_port_registry_is_its_own():
    name = "only_in_the_port"
    catalog.DatasetCatalog.register(name, lambda: [])
    try:
        assert name in catalog.DatasetCatalog and name not in jcatalog.DatasetCatalog
    finally:
        catalog.DatasetCatalog.remove(name)


@pytest.mark.parametrize("fn", [
    "thing_ids", "stuff_ids", "thing_dataset_id_to_contiguous_id",
    "stuff_dataset_id_to_contiguous_id", "contiguous_stuff_to_supercategory",
    "create_keypoint_hflip_indices", "coco_panoptic_metadata"])
def test_builtin_meta_tables_match_jax(fn):
    assert getattr(builtin_meta, fn)() == getattr(jmeta, fn)()


@pytest.mark.parametrize("n", [300, 800, 27])
def test_cluster_metadata_matches_jax(n):
    assert builtin_meta.cluster_metadata(n) == jmeta.cluster_metadata(n)
    assert builtin_meta.create_cate(n) == jmeta.create_cate(n)


def test_builtin_meta_constants_match_jax():
    assert builtin_meta.COCO_PANOPTIC_CATEGORIES == jmeta.COCO_PANOPTIC_CATEGORIES
    assert builtin_meta.STUFF_TO_SUPERCATEGORY == jmeta.STUFF_TO_SUPERCATEGORY
    assert builtin_meta.NUM_SUPERCATEGORIES == jmeta.NUM_SUPERCATEGORIES == 15
    assert builtin_meta.COCO_PERSON_KEYPOINT_FLIP_MAP == jmeta.COCO_PERSON_KEYPOINT_FLIP_MAP


def _snapshot(cat_mod):
    dc, mc = cat_mod.DatasetCatalog, cat_mod.MetadataCatalog
    return dict(dc._registry), dict(mc._registry)


def _restore(cat_mod, snap):
    cat_mod.DatasetCatalog._registry.clear()
    cat_mod.DatasetCatalog._registry.update(snap[0])
    cat_mod.MetadataCatalog._registry.clear()
    cat_mod.MetadataCatalog._registry.update(snap[1])


@pytest.mark.parametrize("cluster_num", [None, 300, 800])
def test_register_all_coco_names_and_metadata_match_jax(cluster_num):
    """The same names in both registries, the same metadata; registration
    reads nothing (the root does not exist)."""
    snaps = _snapshot(catalog), _snapshot(jcatalog)
    try:
        for mod in (catalog, jcatalog):
            mod.DatasetCatalog.clear()
            mod.MetadataCatalog.clear()
        builtin.register_all_coco("/nonexistent", cluster_num=cluster_num)
        jbuiltin.register_all_coco("/nonexistent", cluster_num=cluster_num)
        builtin.register_ade20k("/nonexistent")
        jbuiltin.register_ade20k("/nonexistent")
        names = catalog.DatasetCatalog.list()
        assert names == jcatalog.DatasetCatalog.list()
        assert "coco_2017_val_panoptic_separated" in names
        assert "keypoints_coco_2017_val" in names and "ade20k_sem_seg_val" in names
        if cluster_num:
            assert f"u2seg_{cluster_num}_val_panoptic_separated" in names
        for n in catalog.MetadataCatalog.list():
            assert (catalog.MetadataCatalog.get(n).as_dict()
                    == jcatalog.MetadataCatalog.get(n).as_dict()), n
    finally:
        _restore(catalog, snaps[0])
        _restore(jcatalog, snaps[1])


def test_load_coco_json_matches_jax(synthetic):
    ds = synthetic
    got = coco.load_coco_json(ds.instances_json, ds.image_dir, "port_synth")
    ref = jcoco.load_coco_json(ds.instances_json, ds.image_dir, "jax_synth")
    assert got == ref and len(got) == 4
    assert all(2 <= len(d["annotations"]) <= 6 for d in got)
    a = catalog.MetadataCatalog.get("port_synth").as_dict()
    b = jcatalog.MetadataCatalog.get("jax_synth").as_dict()
    a.pop("name"), b.pop("name")
    assert a == b and len(a["thing_classes"]) == 80
    extra = coco.load_coco_json(ds.instances_json, ds.image_dir,
                                extra_annotation_keys=["segmentation", "id"])
    assert extra == jcoco.load_coco_json(ds.instances_json, ds.image_dir,
                                         extra_annotation_keys=["segmentation", "id"])


def test_load_sem_seg_and_merge_match_jax(synthetic):
    ds = synthetic
    for ext in ("png", "jpg"):
        got = coco.load_sem_seg(ds.sem_seg_dir, ds.image_dir, image_ext=ext)
        assert got == jcoco.load_sem_seg(ds.sem_seg_dir, ds.image_dir, image_ext=ext)
    sem = coco.load_sem_seg(ds.sem_seg_dir, ds.image_dir, image_ext="png")
    det = coco.load_coco_json(ds.instances_json, ds.image_dir)
    merged = coco.merge_to_panoptic(det, sem)
    assert merged == jcoco.merge_to_panoptic(det, sem)
    assert all("sem_seg_file_name" in d for d in merged)


def test_registered_panoptic_dataset_matches_jax(synthetic, tmp_path):
    ds = synthetic
    name = "synthetic_separated_case"
    coco.register_coco_panoptic_separated(
        name, builtin_meta.cluster_metadata(800), ds.image_dir, ds.panoptic_dir,
        ds.panoptic_json, ds.sem_seg_dir, ds.instances_json)
    jcoco.register_coco_panoptic_separated(
        name, jmeta.cluster_metadata(800), ds.image_dir, ds.panoptic_dir,
        ds.panoptic_json, ds.sem_seg_dir, ds.instances_json)
    try:
        for n in (name + "_separated", name + "_stuffonly"):
            assert catalog.DatasetCatalog.get(n) == jcatalog.DatasetCatalog.get(n)
            assert (catalog.MetadataCatalog.get(n).as_dict()
                    == jcatalog.MetadataCatalog.get(n).as_dict())
    finally:
        for mod in (catalog, jcatalog):
            for n in (name + "_separated", name + "_stuffonly"):
                mod.DatasetCatalog.remove(n)
                mod.MetadataCatalog.remove(n)


@pytest.mark.parametrize("size,world", [(0, 1), (1, 1), (16, 1), (16, 3), (5, 8),
                                        (10, 4), (7, 2)])
def test_inference_sampler_shards_match_jax(size, world):
    shards = [list(loader.InferenceSampler(size, r, world)) for r in range(world)]
    assert shards == [list(jloader.InferenceSampler(size, r, world))
                      for r in range(world)]
    assert sum(shards, []) == list(range(size))       # contiguous, each once
    assert max(map(len, shards)) - min(map(len, shards)) <= 1
    assert [len(loader.InferenceSampler(size, r, world)) for r in range(world)] == \
        list(map(len, shards))


@pytest.mark.parametrize("n,batch,world", [(7, 3, 1), (6, 3, 1), (9, 4, 2), (1, 4, 1)])
def test_test_loader_pads_like_jax(n, batch, world):
    dicts = [{"i": i} for i in range(n)]

    def mapper(d, rng):
        return None if d["i"] == 2 else {"i": d["i"], "r": int(rng.randint(1000))}

    for rank in range(world):
        got = list(loader.build_detection_test_loader(dicts, mapper, batch, rank, world))
        ref = list(jloader.build_detection_test_loader(dicts, mapper, batch, rank, world))
        assert got == ref
        assert all(len(b) == batch for b in got)
        flags = [e["is_padding"] for b in got for e in b]
        real = flags.count(False)
        assert flags == [False] * real + [True] * (len(flags) - real)   # tail only


def test_crowd_filter_matches_jax():
    dicts = [{"annotations": []}, {"annotations": [{"iscrowd": 1}]},
             {"annotations": [{"iscrowd": 0}]}, {"annotations": [{}]},
             {"annotations": [{"iscrowd": 1}, {"iscrowd": 0}]}]
    got = loader.filter_images_with_only_crowd_annotations(dicts)
    assert got == jloader.filter_images_with_only_crowd_annotations(dicts)
    assert got == dicts[2:]
