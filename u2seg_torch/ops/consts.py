"""Small constant tensors cached per device.

Creating a tensor from Python values on a GPU is a host-to-device copy that
waits for the stream; the routing code needs a few such tables per call, so
they are made once per (values, dtype, device). Divisions in routing code
use these 0-dim tensors as divisors on purpose: PyTorch's CUDA kernels turn
division by a Python scalar into a multiply by its reciprocal, which can
differ from the JAX package's true division by one ulp, and a level index is
the floor of such a quotient.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import torch


@lru_cache(maxsize=256)
def _table(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def device_table(values: Sequence, dtype: torch.dtype,
                 device) -> torch.Tensor:
    """1-D tensor of ``values`` on ``device`` (cached; do not modify)."""
    return _table(tuple(values), dtype, torch.device(device))


def scalar(value: float, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """0-dim tensor holding ``value`` on ``device`` (cached)."""
    return _table(value, dtype, torch.device(device))
