"""Test-time sampling and loading (counterpart of the test half of
``u2seg_tpu/data/loader.py``; detectron2's ``InferenceSampler`` and
``build_detection_test_loader``).

``InferenceSampler`` splits one pass over a dataset into contiguous,
balanced shards, one per process. No evaluator gathers the shards again:
each process scores its own images, as in the JAX package.
"""
from __future__ import annotations

import logging
from typing import Callable, Iterator, List

import numpy as np

logger = logging.getLogger(__name__)


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
