"""Tracing-safety helpers (counterpart of ``u2seg_tpu/utils/tracing.py``,
after ``detectron2/utils/tracing.py``: is_fx_tracing :30, assert_fx_safe
:45).

Under ``torch.export``, ``torch.compile`` or a ``FakeTensorMode`` a tensor
has no values: a host-side check would read an abstract value (and fail), and
a constant cached during the trace would be a fake tensor that a later eager
call must not receive. These helpers tell the two apart.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch._guards
from torch._subclasses.fake_tensor import FakeTensor


def _fx_symbolic_tracing() -> bool:
    import torch.fx._symbolic_trace as st

    return getattr(st, "is_fx_symbolic_tracing", st.is_fx_tracing)()


def is_tracing(x: Any = None) -> bool:
    """True under ``torch.export``, ``torch.compile``, ``torch.fx`` symbolic
    tracing or an active ``FakeTensorMode`` (or when ``x`` is a fake
    tensor)."""
    if x is not None and isinstance(x, FakeTensor):
        return True
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return True
    if _fx_symbolic_tracing():
        return True
    return torch._guards.detect_fake_mode() is not None


def assert_trace_safe(condition: Callable[[], bool], message: str = "") -> None:
    """Run an assertion only on concrete values (ref assert_fx_safe): under a
    trace the predicate reads abstract values, so it is skipped, as is a
    predicate that raises while evaluating."""
    if is_tracing():
        return
    try:
        ok = condition()
    except Exception:
        return
    assert ok, message


def checkify_nan(x: torch.Tensor, name: str = "value") -> torch.Tensor:
    """Warn when ``x`` holds a NaN or an Inf; returns ``x``. In eager mode
    this reads a flag back to the host (a sync of the device's stream); under
    ``torch.export`` or ``torch.compile`` it is a no-op (a host print has no
    place in the graph)."""
    if is_tracing(x):
        return x
    if not bool(torch.isfinite(x).all()):
        import warnings

        warnings.warn(f"non-finite values in {name}")
    return x
