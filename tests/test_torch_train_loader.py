"""The port's training samplers and train loader
(``u2seg_torch/data/loader.py``) against the JAX package's, on the same seed,
rank and number of workers: the index streams and the first batches are
equal (the mappers are each package's own ``DatasetMapper`` on a set written
by ``write_synthetic_u2seg_train``; their outputs are equal, see
``tests/test_torch_mapper.py``). Also: the prefetch thread stops when the
consumer closes or drops the loader, and a mapper error reaches the
consumer (the JAX loader ends its stream silently there). The port maps in
worker processes where the JAX package has a thread pool: examples cross
intact, on one torch thread in another pid; a worker that dies, a seed the
``RandomState`` refuses and the trainer's own exit or death end the stream
or the workers instead of hanging. Each test that starts workers runs under
a time limit of its own (``time_limit``).
"""
import gc
import itertools
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from u2seg_tpu.config.config import Config as JConfig
from u2seg_tpu.data import loader as jloader
from u2seg_tpu.data import mapper as jmapper
from u2seg_torch.config import Config
from u2seg_torch.data import loader, mapper
from u2seg_torch.data.coco import load_coco_json, load_sem_seg, merge_to_panoptic
from u2seg_torch.testing import write_synthetic_u2seg_train

SIZES = [(120, 160), (96, 128), (160, 120), (100, 75), (150, 200), (80, 96), (90, 140)]


@pytest.fixture
def time_limit():
    """Fail the test, rather than hang the run, if it takes over 60 s."""
    def expire(signum, frame):
        raise TimeoutError("the test ran past its time limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, 60.0)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


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


@pytest.mark.usefixtures("time_limit")
@pytest.mark.parametrize("workers", [0, 1, 2, 4])
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


@pytest.mark.usefixtures("time_limit")
def test_prefetch_thread_stops_when_closed():
    it = loader.build_detection_train_loader([{}] * 5, _slow_mapper, 2, num_workers=3,
                                             prefetch=1)
    for _ in range(3):
        assert next(it)["x"].shape == (2, 2)
    time.sleep(0.1)                       # the producer now waits on a full queue
    it.close()
    assert _wait_stopped(it.thread)


@pytest.mark.usefixtures("time_limit")
def test_prefetch_thread_stops_when_dropped():
    it = loader.build_detection_train_loader([{}] * 5, _slow_mapper, 2, num_workers=2)
    next(it)
    thread = it.thread
    del it
    gc.collect()
    assert _wait_stopped(thread)


@pytest.mark.usefixtures("time_limit")
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


@pytest.mark.usefixtures("time_limit")
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


# -- the worker processes ------------------------------------------------------

def _dead(procs, timeout=10.0):
    """Whether every process in ``procs`` has ended within ``timeout``."""
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    return all(p.exitcode is not None for p in procs)


def _where(dd, rng):
    return {"x": np.array([dd["i"], rng.randint(100)]), "pid": os.getpid(),
            "threads": torch.get_num_threads(), "bucket": (1, 1)}


@pytest.mark.usefixtures("time_limit")
@pytest.mark.parametrize("workers", [1, 3])
def test_workers_map_in_other_processes_on_one_thread(workers):
    before = loader.COUNTS.args()
    threads = torch.get_num_threads()
    it = loader.build_detection_train_loader([{"i": i} for i in range(7)], _where, 2, seed=5,
                                             num_workers=workers)
    batches = [next(it) for _ in range(6)]
    it.close()
    pids = {int(p) for b in batches for p in b["pid"]}
    assert pids <= {p.pid for p in it.processes} and os.getpid() not in pids
    assert {int(n) for b in batches for n in b["threads"]} == {1}
    assert torch.get_num_threads() == threads        # the trainer's pool is its own
    in_workers, in_thread, ready, calls = (a - b for a, b in zip(loader.COUNTS.args(), before))
    assert in_workers >= 12 and in_thread == 0 and calls == 6 and 0 <= ready <= 6
    # the stream does not depend on the number of workers
    one = loader.build_detection_train_loader([{"i": i} for i in range(7)], _where, 2, seed=5,
                                              num_workers=2)
    assert [b["x"].tolist() for b in batches] == [next(one)["x"].tolist() for _ in range(6)]
    one.close()
    assert _dead(it.processes + one.processes)


@pytest.mark.usefixtures("time_limit")
def test_workers_map_nothing_before_the_first_next(tmp_path):
    """Forked at build time, the workers get no work until the consumer
    asks: they do not compete with what the trainer builds meanwhile."""
    log = tmp_path / "mapped"

    def logged(dd, rng):
        with open(log, "a") as f:
            f.write(".")
        return _where(dd, rng)

    it = loader.build_detection_train_loader([{"i": i} for i in range(7)], logged, 2,
                                             num_workers=2)
    time.sleep(0.5)
    assert all(p.is_alive() for p in it.processes) and not log.exists()
    next(it)
    it.close()
    assert log.read_text().count(".") >= 2


def test_the_thread_path_counts_its_examples():
    before = loader.COUNTS.args()
    it = loader.build_detection_train_loader([{"i": i} for i in range(7)], _where, 2,
                                             num_workers=0)
    assert {int(p) for _ in range(3) for p in next(it)["pid"]} == {os.getpid()}
    assert tuple(a - b for a, b in zip(loader.COUNTS.args(), before)) == (0, 6, 0, 0)


def _every_kind(dd, rng):
    if dd["i"] == 1:
        return None
    return {"f32": rng.rand(3, 5).astype(np.float32), "bool": rng.rand(4) > 0.5,
            "i64": np.arange(6, dtype=np.int64).reshape(2, 3)[:, ::2],   # not contiguous
            "scalar": np.float64(dd["i"]), "zero_d": np.array(7, np.int32),
            "empty": np.zeros((0, 4), np.float32), "names": np.array(["a", None], object),
            "text": f"image {dd['i']}", "i": dd["i"], "bucket": (2, 2)}


@pytest.mark.usefixtures("time_limit")
def test_examples_cross_the_process_boundary_intact():
    dd = [{"i": i} for i in range(6)]
    it = loader.build_detection_train_loader(dd, _every_kind, 1, num_workers=2,
                                             sampler=itertools.cycle(range(6)))
    theirs = [next(it) for _ in range(8)]
    it.close()
    g = np.random.RandomState(0)            # the producer's draw: seed 0, rank 0
    ours = []
    for i in itertools.cycle(range(6)):
        ex = _every_kind(dd[i], np.random.RandomState(int(g.randint(2 ** 31))))
        if ex is not None:
            ours.append(loader._stack_batch([ex]))
        if len(ours) == len(theirs):
            break
    for a, b in zip(theirs, ours):
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tolist() == b[k].tolist(), k


class _Unpicklable(Exception):
    def __reduce__(self):
        raise TypeError("no pickling")


@pytest.mark.usefixtures("time_limit")
@pytest.mark.parametrize("kind", [KeyError, FileNotFoundError, _Unpicklable])
def test_a_mapper_error_carries_the_workers_traceback(kind):
    def broken_mapper(dd, rng):
        raise kind("bad segmentation")

    it = loader.build_detection_train_loader([{}] * 3, broken_mapper, 1, num_workers=2)
    with pytest.raises(RuntimeError if kind is _Unpicklable else kind) as e:
        next(it)
    text = str(e.value) + "".join(getattr(e.value, "__notes__", []))
    assert "train loader worker 0" in text and "Traceback" in text
    assert "broken_mapper" in text and "bad segmentation" in text
    assert _wait_stopped(it.thread) and _dead(it.processes)


@pytest.mark.usefixtures("time_limit")
def test_a_killed_worker_ends_the_stream_within_10_s():
    it = loader.build_detection_train_loader([{}] * 5, _slow_mapper, 2, num_workers=2)
    next(it)
    os.kill(it.processes[1].pid, signal.SIGKILL)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"worker 1 .* exit code -9"):
        while time.monotonic() - t0 < 10:
            next(it)
    assert time.monotonic() - t0 < 10
    assert _wait_stopped(it.thread) and _dead(it.processes)


@pytest.mark.usefixtures("time_limit")
@pytest.mark.parametrize("workers", [0, 2])
def test_a_seed_the_random_state_refuses_raises_instead_of_hanging(workers):
    with pytest.raises(ValueError):
        it = loader.build_detection_train_loader([{}] * 5, _slow_mapper, 2,
                                                 seed=5_000_000, num_workers=workers)
        next(it)


@pytest.mark.usefixtures("time_limit")
@pytest.mark.parametrize("how", ["close", "drop"])
def test_no_worker_outlives_the_loader(how):
    it = loader.build_detection_train_loader([{}] * 5, _slow_mapper, 2, num_workers=3)
    next(it)
    procs, thread = it.processes, it.thread
    assert all(p.is_alive() for p in procs)
    if how == "close":
        it.close()
        assert all(p.exitcode is not None for p in procs)
    else:
        del it
        gc.collect()
        assert _wait_stopped(thread)
    assert _dead(procs, timeout=0.0)


_TRAINER = """
import os, signal, sys, time
import numpy as np
from u2seg_torch.data import loader

def m(dd, rng):
    time.sleep(0.01)
    return {"x": np.zeros(2), "bucket": (1, 1)}

it = loader.build_detection_train_loader([{}] * 5, m, 2, num_workers=2)
next(it)
print(" ".join(str(p.pid) for p in it.processes), flush=True)
if sys.argv[1] == "kill":
    os.kill(os.getpid(), signal.SIGKILL)
"""


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    with open(f"/proc/{pid}/stat") as f:        # a zombie has ended
        return f.read().rsplit(")", 1)[1].split()[0] != "Z"


@pytest.mark.usefixtures("time_limit")
@pytest.mark.parametrize("how", ["exit", "kill"])
def test_no_worker_outlives_the_trainer(how):
    """The trainer's process ends without closing its loader: normally, or
    killed; its workers end with it."""
    proc = subprocess.run([sys.executable, "-c", _TRAINER, how], capture_output=True,
                          text=True, timeout=50,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == (-signal.SIGKILL if how == "kill" else 0), proc.stderr
    pids = [int(p) for p in proc.stdout.split()]
    assert len(pids) == 2
    deadline = time.monotonic() + 10
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not any(_alive(p) for p in pids)


def test_counts_lose_no_update_under_contention():
    before = loader.COUNTS.args()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [loader.COUNTS.add(1, 2, 3, 4)
                                                    for _ in range(2000)])
                   for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    n = 2000 * len(threads)
    assert tuple(a - b for a, b in zip(loader.COUNTS.args(), before)) == (n, 2 * n, 3 * n, 4 * n)


def _first_is_slow(dd, rng):
    start = time.monotonic()
    if dd["i"] == 0:
        time.sleep(0.5)
    return {"start": np.array([start]), "x": np.zeros(1 << 19, np.float32), "bucket": (1, 1)}


@pytest.mark.usefixtures("time_limit")
def test_a_worker_does_not_wait_for_its_turn_to_send():
    """Call 0 (worker 0) is slow; worker 1's 2 MB results are read while the
    loader waits for it, so worker 1 maps call 3 without waiting on a send."""
    it = loader.build_detection_train_loader([{"i": i} for i in range(6)], _first_is_slow, 1,
                                             sampler=itertools.cycle(range(6)), num_workers=2)
    starts = [float(next(it)["start"][0]) for _ in range(4)]
    it.close()
    assert starts[3] - starts[0] < 0.4


@pytest.mark.parametrize("items", [[], [{}], [{"i": 1, "segmentation": [[0.5, 1.0, 2.0]]},
                                               {"file_name": "a.jpg"}, {}]])
def test_serialized_dicts_read_back_equal(items):
    dicts = loader._Serialized(items)
    assert len(dicts) == len(items) and [dicts[i] for i in range(len(items))] == items


def test_the_contention_probe_asks_for_the_card(monkeypatch):
    from u2seg_torch.dev import loader_contention

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader_contention.main(["--config-file", "unused.yaml", "--root", "unused"])
