"""The port's training samplers and train loader
(``u2seg_torch/data/loader.py``) against the JAX package's, on the same seed,
rank and number of workers: the index streams and the first batches are
equal (the mappers are each package's own ``DatasetMapper`` on a set written
by ``write_synthetic_u2seg_train``; their outputs are equal, see
``tests/test_torch_mapper.py``). Also: the prefetch thread stops when the
consumer closes or drops the loader, and a mapper error reaches the
consumer (the JAX loader ends its stream silently there).
"""
import gc
import itertools
import time

import numpy as np
import pytest

from u2seg_tpu.config.config import Config as JConfig
from u2seg_tpu.data import loader as jloader
from u2seg_tpu.data import mapper as jmapper
from u2seg_torch.config import Config
from u2seg_torch.data import loader, mapper
from u2seg_torch.data.coco import load_coco_json, load_sem_seg, merge_to_panoptic
from u2seg_torch.testing import write_synthetic_u2seg_train

SIZES = [(120, 160), (96, 128), (160, 120), (100, 75), (150, 200), (80, 96), (90, 140)]


def _small(cfg):
    cfg.input.min_size_train = (64, 96, 128)
    cfg.input.max_size_train = 200
    cfg.input.pad_buckets = ((128, 200), (200, 128))
    cfg.model.max_gt_instances = 24
    return cfg


@pytest.fixture(scope="module")
def dicts(tmp_path_factory):
    ds = write_synthetic_u2seg_train(str(tmp_path_factory.mktemp("u2seg")), SIZES, 41, seed=4)
    return merge_to_panoptic(load_coco_json(ds.instances_json, ds.image_dir),
                             load_sem_seg(ds.sem_seg_dir, ds.image_dir))


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sampler_streams_match_jax(seed, world):
    dd = [{"annotations": [{"category_id": c} for c in np.random.RandomState(i).randint(
        0, 9, i % 4)]} for i in range(23)]
    for rank in range(world):
        for ours, theirs in [
                (loader.TrainingSampler(23, seed=seed, rank=rank, world_size=world),
                 jloader.TrainingSampler(23, seed=seed, rank=rank, world_size=world)),
                (loader.TrainingSampler(23, shuffle=False, seed=seed, rank=rank, world_size=world),
                 jloader.TrainingSampler(23, shuffle=False, seed=seed, rank=rank, world_size=world)),
                (loader.RepeatFactorTrainingSampler(dd, 0.3, seed=seed, rank=rank, world_size=world),
                 jloader.RepeatFactorTrainingSampler(dd, 0.3, seed=seed, rank=rank, world_size=world))]:
            assert list(itertools.islice(ours, 80)) == list(itertools.islice(theirs, 80))


def _same_batch(a, b):
    assert set(a) == set(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if k == "gt_masks":     # f32 bilinear vs OpenCV's float resize
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("workers", [0, 2])
def test_first_batches_match_jax(dicts, workers, monkeypatch):
    """Polygon masks cross the border here; the port's rasteriser can
    differ from OpenCV's there, so both loaders map with the port's
    rasteriser to compare the streams themselves."""
    from u2seg_torch.structures.masks import polygons_to_bitmask

    monkeypatch.setattr(jmapper, "polygons_to_bitmask", polygons_to_bitmask)
    m, jm = mapper.DatasetMapper(_small(Config())), jmapper.DatasetMapper(_small(JConfig()))
    for rank in (0, 1):
        ours = loader.build_detection_train_loader(
            dicts, m, 2, seed=3, rank=rank, world_size=2, num_workers=workers)
        theirs = jloader.build_detection_train_loader(
            dicts, jm, 2, seed=3, rank=rank, world_size=2, num_workers=workers)
        for _ in range(4):
            _same_batch(next(ours), next(theirs))
        if workers:
            ours.close()


def test_stack_batch_matches_jax():
    rng = np.random.RandomState(0)
    ex = [{"image": rng.rand(4, 5, 3).astype(np.float32), "image_id": i, "bucket": (4, 5),
           "height": 4, "image_size": np.array([4, 5], np.int32)} for i in range(3)]
    a, b = loader._stack_batch(ex), jloader._stack_batch(ex)
    assert set(a) == set(b) == {"image", "image_id", "height", "image_size"}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _slow_mapper(dd, rng):
    time.sleep(0.01)
    return {"x": np.full((2,), rng.randint(100), np.int64), "bucket": (1, 1)}


def _wait_stopped(thread, timeout=10.0):
    thread.join(timeout)
    return not thread.is_alive()


def test_prefetch_thread_stops_when_closed():
    it = loader.build_detection_train_loader([{}] * 5, _slow_mapper, 2, num_workers=3,
                                             prefetch=1)
    for _ in range(3):
        assert next(it)["x"].shape == (2, 2)
    time.sleep(0.1)                       # the producer now waits on a full queue
    it.close()
    assert _wait_stopped(it.thread)


def test_prefetch_thread_stops_when_dropped():
    it = loader.build_detection_train_loader([{}] * 5, _slow_mapper, 2, num_workers=2)
    next(it)
    thread = it.thread
    del it
    gc.collect()
    assert _wait_stopped(thread)


def test_mapper_error_reaches_the_consumer():
    def broken(dd, rng):
        if dd["i"] == 3:
            raise ValueError("bad annotation")
        return {"x": np.zeros(1), "bucket": (1, 1)}

    it = loader.build_detection_train_loader([{"i": i} for i in range(10)], broken, 1,
                                             sampler=iter(range(10)), num_workers=2)
    got = []
    with pytest.raises(ValueError, match="bad annotation"):
        for b in it:
            got.append(b)
    assert len(got) == 3 and _wait_stopped(it.thread)
    with pytest.raises(StopIteration):
        next(it)


def test_finite_sampler_ends_the_stream_like_jax():
    def m(dd, rng):
        return {"x": np.array([dd["i"]]), "bucket": (1, 1)}

    dd = [{"i": i} for i in range(9)]
    for workers in (0, 2):
        ours = list(loader.build_detection_train_loader(dd, m, 2, sampler=iter(range(9)),
                                                        num_workers=workers))
        theirs = list(jloader.build_detection_train_loader(dd, m, 2, sampler=iter(range(9)),
                                                           num_workers=workers))
        assert [b["x"].tolist() for b in ours] == [b["x"].tolist() for b in theirs]
