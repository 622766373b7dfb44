"""Samplers and batched data loaders (counterpart of
``u2seg_tpu/data/loader.py``; detectron2's ``data/build.py``,
``samplers/distributed_sampler.py`` and ``common.py``).

Training: the sampler shards an endless shuffled index stream by rank; the
mapper makes bucket-padded fixed-size examples; batches group examples of
one bucket (the static-shape form of aspect-ratio grouping). With
``num_workers > 0`` a thread pool maps ahead of the consumer, each example
with its own ``RandomState`` drawn in submission order, so the batch stream
depends on the seed, the rank and whether there are workers, and not on
their number or timing: the JAX package's stream, example for example.

Test: ``InferenceSampler`` splits one pass into contiguous, balanced shards,
one per process. No evaluator gathers the shards again: each process scores
its own images, as in the JAX package.
"""
from __future__ import annotations

import logging
import queue
import threading
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


class TrainingSampler:
    """Endless shuffled index stream; process ``rank`` of ``world_size``
    takes every ``world_size``-th index of each epoch's permutation."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        if size <= 0:
            raise ValueError(f"TrainingSampler needs a non-empty dataset, got {size}")
        self.size = size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size

    def __iter__(self) -> Iterator[int]:
        g = np.random.RandomState(self.seed)
        while True:
            order = g.permutation(self.size) if self.shuffle else np.arange(self.size)
            yield from order[self.rank::self.world_size].tolist()


class RepeatFactorTrainingSampler(TrainingSampler):
    """Class-balanced resampling: an image repeats ``max(1, sqrt(t / f_c))``
    times for its rarest category c of frequency f_c (stochastic rounding
    per epoch)."""

    def __init__(self, dataset_dicts: List[dict], repeat_thresh: float,
                 shuffle: bool = True, seed: int = 0, rank: int = 0,
                 world_size: int = 1):
        freq: Dict[int, int] = defaultdict(int)
        n = len(dataset_dicts)
        for d in dataset_dicts:
            for cid in {a["category_id"] for a in d.get("annotations", [])}:
                freq[cid] += 1
        cat_repeat = {cid: max(1.0, np.sqrt(repeat_thresh / (c / n)))
                      for cid, c in freq.items()}
        self._repeats = []
        for d in dataset_dicts:
            cats = {a["category_id"] for a in d.get("annotations", [])}
            self._repeats.append(max([cat_repeat.get(c, 1.0) for c in cats], default=1.0))
        super().__init__(n, shuffle, seed, rank, world_size)

    def __iter__(self) -> Iterator[int]:
        g = np.random.RandomState(self.seed)
        while True:
            rands = g.rand(self.size)
            indices = []
            for i, rf in enumerate(self._repeats):
                rep = int(rf) + (1 if rands[i] < (rf - int(rf)) else 0)
                indices.extend([i] * rep)
            order = g.permutation(len(indices)) if self.shuffle else np.arange(len(indices))
            sel = [indices[j] for j in order]
            yield from sel[self.rank::self.world_size]


def _stack_batch(examples: List[dict]) -> dict:
    """Examples of one bucket -> one dict of stacked arrays (``bucket``
    dropped)."""
    out = {}
    for k in examples[0]:
        if k == "bucket":
            continue
        vals = [e[k] for e in examples]
        out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else np.asarray(vals)
    return out


class _Batcher:
    """Group examples by bucket; a batch is ready when a bucket holds
    ``batch_size`` examples."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.buffers: Dict[tuple, List[dict]] = defaultdict(list)

    def add(self, ex: Optional[dict]) -> Optional[dict]:
        if ex is None:                  # no instance survived: draw another image
            return None
        b = self.buffers[ex["bucket"]]
        b.append(ex)
        if len(b) < self.batch_size:
            return None
        self.buffers[ex["bucket"]] = []
        return _stack_batch(b)


def build_detection_train_loader(
    dataset_dicts: List[dict],
    mapper: Callable[[dict, np.random.RandomState], Optional[dict]],
    total_batch_size: int,
    seed: int = 0,
    rank: int = 0,
    world_size: int = 1,
    sampler: Optional[Iterable[int]] = None,
    prefetch: int = 2,
    num_workers: int = 4,
) -> Iterator[dict]:
    """Endless stream of batches of ``total_batch_size`` examples of one
    bucket, for process ``rank`` of ``world_size``.

    ``num_workers <= 0``: examples are mapped on the consumer's thread, all
    with one ``RandomState(seed * 1000 + rank)``. Otherwise a producer
    thread keeps ``2 * num_workers`` mapper calls in flight on a thread
    pool, each with its own ``RandomState`` drawn from that one in
    submission order, and hands batches over through a queue of
    ``prefetch``; the returned iterator's ``close()`` (also run when it is
    garbage-collected) stops the thread.
    """
    if sampler is None:
        sampler = TrainingSampler(len(dataset_dicts), seed=seed, rank=rank,
                                  world_size=world_size)
    if num_workers <= 0:
        def generate() -> Iterator[dict]:
            rng = np.random.RandomState(seed * 1000 + rank)
            batcher = _Batcher(total_batch_size)
            for idx in sampler:
                batch = batcher.add(mapper(dataset_dicts[idx], rng))
                if batch is not None:
                    yield batch
        return generate()
    return PrefetchLoader(dataset_dicts, mapper, sampler, total_batch_size,
                          seed * 1000 + rank, num_workers, max(prefetch, 1))


_DONE = object()


def _put(q: "queue.Queue", stop: threading.Event, item) -> bool:
    """Put ``item`` unless ``stop`` is set first (checked every 0.1 s)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            pass
    return False


def _produce(q, stop, dicts, mapper, sampler, batch_size, rng_seed, num_workers):
    """The producer thread of ``PrefetchLoader``: it holds no reference to
    the loader, so dropping the loader closes it."""
    rng_global = np.random.RandomState(rng_seed)
    pool = ThreadPoolExecutor(max_workers=num_workers, thread_name_prefix="mapper")
    batcher = _Batcher(batch_size)
    inflight: "queue.Queue" = queue.Queue()
    it = iter(sampler)

    def submit():
        idx = next(it)
        seed_i = int(rng_global.randint(2 ** 31))
        inflight.put(pool.submit(mapper, dicts[idx], np.random.RandomState(seed_i)))

    try:
        for _ in range(num_workers * 2):          # a window of calls in flight
            submit()
        while not stop.is_set():
            fut = inflight.get()
            submit()
            batch = batcher.add(fut.result())
            if batch is not None and not _put(q, stop, batch):
                break
    except StopIteration:                         # a finite sampler ran out
        pass
    except BaseException as e:                    # handed to the consumer
        _put(q, stop, e)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)   # running calls finish first
        _put(q, stop, _DONE)


class PrefetchLoader:
    """The threaded train loader: a producer thread (``thread``) maps on a
    pool of ``num_workers`` threads and puts batches in a queue of
    ``prefetch``. A mapper error is raised at the consumer's ``next()``.
    ``close()`` stops the producer and returns once it and the mapper calls
    it started have ended; dropping the loader stops it too. The producer
    never waits for longer than 0.1 s at a time without looking."""

    def __init__(self, dataset_dicts, mapper, sampler, batch_size: int,
                 rng_seed: int, num_workers: int, prefetch: int):
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._empty = queue.Empty          # still bound when __del__ runs at exit
        self._stop = threading.Event()
        self._finished = False
        self.thread = threading.Thread(
            target=_produce, daemon=True, name="train-loader",
            args=(self._queue, self._stop, dataset_dicts, mapper, sampler,
                  batch_size, rng_seed, num_workers))
        self.thread.start()

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._finished:
            raise StopIteration
        item = self._queue.get()
        if item is _DONE or isinstance(item, BaseException):
            self._finished = True
            self._stop_producer()
            if item is _DONE:
                raise StopIteration
            raise item
        return item

    def _stop_producer(self) -> None:
        self._stop.set()
        while True:                       # drop what it queued
            try:
                self._queue.get_nowait()
            except self._empty:
                break

    def close(self, timeout: float = 60.0) -> None:
        """Stop the producer; wait for it and its mapper calls to end."""
        self._stop_producer()
        self.thread.join(timeout)

    def __del__(self):
        self._stop_producer()


class InferenceSampler:
    """Balanced one-pass shards (ref distributed_sampler.py:129)."""

    def __init__(self, size: int, rank: int = 0, world_size: int = 1):
        self.size = size
        shard_sizes = [
            size // world_size + int(r < size % world_size)
            for r in range(world_size)
        ]
        begin = sum(shard_sizes[:rank])
        self._local = list(range(begin, begin + shard_sizes[rank]))

    def __iter__(self):
        return iter(self._local)

    def __len__(self):
        return len(self._local)


def build_detection_test_loader(
    dataset_dicts: List[dict],
    mapper: Callable,
    batch_size: int = 1,
    rank: int = 0,
    world_size: int = 1,
) -> Iterator[List[dict]]:
    """One pass, in order, padding the final partial batch by repeating the
    last example (flagged with ``is_padding``) so shapes stay static."""
    sampler = InferenceSampler(len(dataset_dicts), rank, world_size)
    rng = np.random.RandomState(0)
    batch: List[dict] = []
    for idx in sampler:
        ex = mapper(dataset_dicts[idx], rng)
        if ex is None:
            continue
        ex["is_padding"] = False
        batch.append(ex)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch:
        while len(batch) < batch_size:
            pad = dict(batch[-1])
            pad["is_padding"] = True
            batch.append(pad)
        yield batch


def filter_images_with_only_crowd_annotations(dataset_dicts: List[dict]) -> List[dict]:
    """ref data/build.py:46."""
    def ok(d):
        return any(a.get("iscrowd", 0) == 0 for a in d.get("annotations", []))

    out = [d for d in dataset_dicts if ok(d)]
    logger.info(
        "Removed %d images with no usable annotations. %d images left.",
        len(dataset_dicts) - len(out), len(out),
    )
    return out
