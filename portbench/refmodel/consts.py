"""Small constant tensors cached per device.

Creating a tensor from Python values on a GPU is a host-to-device copy that
waits for the stream; the routing code needs a few such tables per call, so
they are made once per (values, dtype, device); a trace's tensors are not
kept (``cached_constant``). Divisions in routing code
use these 0-dim tensors as divisors on purpose: PyTorch's CUDA kernels turn
division by a Python scalar into a multiply by its reciprocal, which can
differ from the JAX package's true division by one ulp, and a level index is
the floor of such a quotient.
"""
from __future__ import annotations

from typing import Sequence

import torch

_TABLES: dict = {}


def cached_constant(key, make):
    """``make()`` once per ``key``. A tensor made under ``torch.export`` or a
    fake mode is a trace's (a subclass of ``torch.Tensor``, without values):
    it is returned and never kept, so no eager call later receives it."""
    t = _TABLES.get(key)
    if t is None:
        t = make()
        if type(t) is torch.Tensor:
            if len(_TABLES) >= 1024:
                _TABLES.clear()
            _TABLES[key] = t
    return t


def _table(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return cached_constant(("table", values, dtype, device),
                           lambda: torch.tensor(values, dtype=dtype, device=device))


def device_table(values: Sequence, dtype: torch.dtype,
                 device) -> torch.Tensor:
    """1-D tensor of ``values`` on ``device`` (cached; do not modify)."""
    return _table(tuple(values), dtype, torch.device(device))


def scalar(value: float, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """0-dim tensor holding ``value`` on ``device`` (cached)."""
    return _table(value, dtype, torch.device(device))
