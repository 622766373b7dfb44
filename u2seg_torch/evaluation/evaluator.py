"""Evaluator protocol and inference loop (counterpart of
``u2seg_tpu/evaluation/evaluator.py``; detectron2's ``evaluation/evaluator.py``).

``DatasetEvaluators.evaluate`` runs its evaluators in list order. The U2Seg
stack relies on it: in ``auto`` mode the panoptic evaluator reads the
mappings that the semantic and instance evaluators wrote just before.
"""
from __future__ import annotations

import logging
import time
from collections import OrderedDict
from typing import Callable, Iterable, List, Optional

logger = logging.getLogger(__name__)


class DatasetEvaluator:
    """reset() -> process(inputs, outputs)* -> evaluate() -> dict."""

    def reset(self):
        pass

    def process(self, inputs, outputs):
        pass

    def evaluate(self):
        pass


class DatasetEvaluators(DatasetEvaluator):
    def __init__(self, evaluators: List[DatasetEvaluator]):
        self._evaluators = evaluators

    def reset(self):
        for e in self._evaluators:
            e.reset()

    def process(self, inputs, outputs):
        for e in self._evaluators:
            e.process(inputs, outputs)

    def evaluate(self):
        results = OrderedDict()
        for e in self._evaluators:
            r = e.evaluate()
            if r is not None:
                for k, v in r.items():
                    assert k not in results, f"Duplicate eval key {k}"
                    results[k] = v
        return results


def inference_on_dataset(
    predict_fn: Callable,
    data_loader: Iterable,
    evaluator: Optional[DatasetEvaluator],
    warmup: int = 1,
) -> dict:
    """Run predict_fn over the loader, feed the evaluator, time the phases
    (ref evaluator.py:103-220: warmup-aware pure-compute timing)."""
    if evaluator is None:
        evaluator = DatasetEvaluator()
    evaluator.reset()
    num = 0
    t_compute = 0.0
    t_total_start = time.perf_counter()
    for idx, inputs in enumerate(data_loader):
        t0 = time.perf_counter()
        outputs = predict_fn(inputs)
        if idx >= warmup:
            t_compute += time.perf_counter() - t0
            num += len(inputs) if hasattr(inputs, "__len__") else 1
        evaluator.process(inputs, outputs)
    total = time.perf_counter() - t_total_start
    if num > 0:
        logger.info(
            "inference done: %.4f s/iter pure compute, %.1f s total",
            t_compute / max(num, 1), total,
        )
    results = evaluator.evaluate()
    return results if results is not None else {}
