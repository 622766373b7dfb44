"""PreciseBN: re-estimate BatchNorm statistics with true averages
(counterpart of ``u2seg_tpu/engine/precise_bn.py``).

Run N training batches through the model (no parameter update) and replace
the EMA running statistics with the true mean of the per-batch moments. The
port's BatchNorm blends ``new = m * old + (1 - m) * batch`` with a fixed
momentum m, so each batch's moments are recovered from the update,
``batch = (new - m * old) / (1 - m)``, and averaged; the model needs no
change.
"""
from __future__ import annotations

import itertools
import logging
from typing import Callable, Iterable

import torch

from u2seg_torch.engine.hooks import HookBase
from u2seg_torch.engine.train_loop import batch_from_numpy
from u2seg_torch.engine.trainer import bn_running_stats
from u2seg_torch.parallel import comm
from u2seg_torch.parallel.mesh import shard_batch

logger = logging.getLogger(__name__)

BN_MOMENTUM = 0.9  # must match ops.norms.get_norm


@torch.no_grad()
def estimate_bn_stats(
    model: torch.nn.Module,
    forward: Callable[[object], object],
    batches: Iterable,
    num_iters: int = 200,
    momentum: float = BN_MOMENTUM,
) -> int:
    """Call ``forward(batch)`` (a training-mode forward of ``model``) on up
    to ``num_iters`` batches, then set the running statistics of every
    BatchNorm of ``model`` that is not frozen to the average of the batches'
    moments. Returns the number of batches; with none, nothing changes."""
    stats = bn_running_stats(model)
    acc = [torch.zeros_like(t) for t in stats]
    count = 0
    # islice: take no batch beyond the last one used (the JAX loop draws one
    # more from the trainer's loader and drops it)
    for batch in itertools.islice(batches, num_iters):
        old = [t.clone() for t in stats]
        forward(batch)
        for a, new, o in zip(acc, stats, old):
            a += (new - momentum * o) / (1.0 - momentum)
        count += 1
    if count == 0:
        logger.warning("PreciseBN saw no batches; stats unchanged")
        return 0
    for t, a in zip(stats, acc):
        t.copy_(a / count)
    logger.info("PreciseBN: averaged statistics over %d batches", count)
    return count


class PreciseBN(HookBase):
    """Hook: every ``period`` iterations (and at the end of training)
    re-estimate the trainer's BatchNorm statistics from ``num_iters`` loader
    batches. The sampling generator is seeded with 0 for every batch, and
    the new statistics are averaged over the processes."""

    def __init__(self, period: int, num_iters: int = 200):
        self._period = period
        self._num_iters = num_iters

    def _run(self):
        trainer = self.trainer
        model = trainer.model
        gen = torch.Generator(device=trainer.device)

        def forward(raw):
            b = shard_batch(trainer.mesh, batch_from_numpy(raw))
            model(b.images, b.image_sizes, gt=b.gt, sem_seg_gt=b.sem_seg,
                  train=True, generator=gen.manual_seed(0))

        def batches():
            while True:
                yield trainer._next_batch_raw()

        model.train()
        estimate_bn_stats(model, forward, batches(), self._num_iters)
        comm.all_reduce_mean_(bn_running_stats(model))

    def after_step(self):
        it = self.trainer.iter
        if self._period > 0 and (it + 1) % self._period == 0:
            self._run()

    def after_train(self):
        if self.trainer.iter + 1 >= self.trainer.max_iter:
            self._run()
