"""Result checking helpers (counterpart of ``u2seg_tpu/evaluation/testing.py``).

``flatten_results_dict`` lives in ``engine.hooks`` and is re-exported here.
"""
from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Mapping

import numpy as np

from u2seg_torch.engine.hooks import flatten_results_dict  # noqa: F401

logger = logging.getLogger(__name__)


def print_csv_format(results: Mapping) -> None:
    """Log metrics in the reference's copy-paste friendly format."""
    for task, res in results.items():
        if not isinstance(res, Mapping):
            continue
        important = {k: v for k, v in res.items() if "-" not in k}
        logger.info("copypaste: Task: %s", task)
        logger.info("copypaste: %s", ",".join(important.keys()))
        logger.info(
            "copypaste: %s",
            ",".join(f"{v:0.4f}" for v in important.values()),
        )


def verify_results(expected_results, results) -> bool:
    """Check metrics against (task, metric, value, tolerance) tuples
    (ref testing.py:31; cfg.TEST.EXPECTED_RESULTS)."""
    if not expected_results:
        return True
    ok = True
    for task, metric, expected, tolerance in expected_results:
        actual = results[task].get(metric)
        if actual is None or not np.isfinite(actual):
            ok = False
            continue
        diff = abs(actual - expected)
        if diff > tolerance:
            ok = False
            logger.error(
                "FAIL %s/%s = %.4f, expected %.4f ± %.4f",
                task, metric, actual, expected, tolerance,
            )
        else:
            logger.info(
                "PASS %s/%s = %.4f (expected %.4f ± %.4f)",
                task, metric, actual, expected, tolerance,
            )
    if not ok:
        logger.error("Result verification failed!")
    return ok
