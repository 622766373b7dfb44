"""Model analysis: parameter, FLOP and byte counts (counterpart of
``u2seg_tpu/utils/analysis.py``, after ``detectron2/utils/analysis.py``
flop_count_operators :55, parameter_count :103, find_unused_parameters :158).

The JAX module reads FLOPs and "bytes accessed" from XLA's cost analysis of
the compiled forward. Here they come from the forward itself, run once under
two dispatch modes: ``torch.utils.flop_counter.FlopCounterMode`` (convs,
GEMMs, attention, and the registered K1 op through its FLOP formula, the
count of its plain twin) and ``BytesAccessedMode``, which sums the bytes of
every operand and result of every aten op that is not a view. That sum is
this package's counterpart of XLA's "bytes accessed": like it, it counts each
op's traffic on its own, as if nothing stayed in cache between ops.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def parameter_count(model: torch.nn.Module) -> int:
    """Number of parameter elements of ``model.named_parameters()``."""
    return sum(p.numel() for _, p in model.named_parameters())


def parameter_count_by_module(model: torch.nn.Module, depth: int = 2) -> Dict[str, int]:
    """Parameter elements per module path cut at ``depth`` dotted names
    (``backbone.bottom_up``, ``roi_heads.box_head``, ...), in the order of
    ``named_parameters()``."""
    out: Dict[str, int] = {}
    for name, p in model.named_parameters():
        key = ".".join(name.split(".")[:depth])
        out[key] = out.get(key, 0) + p.numel()
    return out


def parameter_count_table(model: torch.nn.Module, max_depth: int = 3) -> str:
    """The JAX module's table: the model, then every module path down to
    ``max_depth`` names, with its parameters in millions."""
    totals: Dict[Tuple[str, ...], int] = defaultdict(int)
    order: List[Tuple[str, ...]] = [()]
    for name, p in model.named_parameters():
        parts = tuple(name.split("."))
        for d in range(0, min(len(parts), max_depth) + 1):
            key = parts[:d]
            if key not in totals:
                order.append(key) if key else None
            totals[key] += p.numel()
    rows = [("  " * len(k) + (k[-1] if k else "model"), totals[k]) for k in order]
    width = max(len(r[0]) for r in rows)
    return "\n".join(f"{n:<{width}} | {c / 1e6:8.3f}M" for n, c in rows)


def find_unused_parameters(model: torch.nn.Module) -> List[str]:
    """Names of trainable parameters whose gradient (after a backward) is
    None or exactly zero (ref analysis.py:158)."""
    return [name for name, p in model.named_parameters() if p.requires_grad
            and (p.grad is None or float(p.grad.detach().abs().max()) == 0.0)]


def _is_view(func) -> bool:
    schema = getattr(func, "_schema", None)
    return bool(schema is not None and schema.returns
                and any(r.alias_info is not None and not r.alias_info.is_write
                        for r in schema.returns))


class BytesAccessedMode(TorchDispatchMode):
    """Sums, per aten op that is not a view, the bytes of its tensor
    operands and results (``total``; ``by_op`` per op name)."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.by_op: Dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _is_view(func):
            n = sum(t.numel() * t.element_size()
                    for t in tree_leaves((args, kwargs or {}, out))
                    if isinstance(t, torch.Tensor))
            self.total += n
            self.by_op[str(func.overloadpacket)] += n
        return out


def flop_count(fn: Callable, *args) -> Dict[str, object]:
    """Run ``fn(*args)`` once and count: {"flops": total, "bytes_accessed":
    total, "flops_by_op": {op: flops}, "bytes_by_op": {op: bytes}}. FLOPs
    count a multiply-add as 2."""
    from torch.utils.flop_counter import FlopCounterMode

    flops = FlopCounterMode(display=False)
    nbytes = BytesAccessedMode()
    with torch.no_grad(), flops, nbytes:
        fn(*args)
    by_op = {str(k): int(v) for k, v in flops.get_flop_counts().get("Global", {}).items()}
    return {"flops": float(flops.get_total_flops()), "bytes_accessed": float(nbytes.total),
            "flops_by_op": by_op, "bytes_by_op": dict(nbytes.by_op)}
