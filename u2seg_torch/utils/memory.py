"""OOM-resilient calls (counterpart of ``u2seg_tpu/utils/memory.py``, after
``detectron2/utils/memory.py:26`` retry_if_cuda_oom): on
``torch.cuda.OutOfMemoryError`` free what can be freed and retry once, then
run the call on the CPU.

No call on a path that ``chip_smoke.py`` drives is wrapped (the JAX
package's wrapper wraps none either): a move to the CPU would hide the
kernels."""
from __future__ import annotations

import functools
import gc
import logging
from typing import Any, Callable

import torch

logger = logging.getLogger(__name__)


def _to_cpu(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def retry_if_oom(fn: Callable) -> Callable:
    """Wrap ``fn``: on ``torch.cuda.OutOfMemoryError`` (and nothing else) run
    ``gc.collect()`` and ``torch.cuda.empty_cache()`` and retry once; if that
    runs out of memory too, call ``fn`` on copies of its tensor arguments on
    the CPU (logged at WARNING). The CPU result is returned as it is."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except torch.cuda.OutOfMemoryError:
            pass
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        try:
            return fn(*args, **kwargs)
        except torch.cuda.OutOfMemoryError:
            pass
        logger.warning("%s: out of device memory, retrying on CPU",
                       getattr(fn, "__name__", fn))
        return fn(*_to_cpu(args), **_to_cpu(kwargs))

    return wrapped
