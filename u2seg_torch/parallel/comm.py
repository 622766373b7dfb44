"""Cross-process communication over ``torch.distributed`` (counterpart of
``u2seg_tpu/parallel/comm.py``).

With no process group initialised every helper is the world-of-one case:
rank 0 of 1, no collective. Objects travel by ``all_gather_object`` (pickle);
``all_reduce_mean_`` and ``broadcast_`` move tensors, each in one
collective over one flat buffer; ``all_gather_rows`` concatenates every
process's rows of a tensor.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def _collective_device() -> torch.device:
    """Where the default group's backend takes tensors: the current CUDA
    device for NCCL, the CPU otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def synchronize() -> None:
    """Barrier across processes."""
    if get_world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_gather(data: Any) -> List[Any]:
    """A picklable object from every process, in rank order."""
    world = get_world_size()
    if world == 1:
        return [data]
    out: List[Any] = [None] * world
    dist.all_gather_object(out, data)
    return out


def gather(data: Any, dst: int = 0) -> List[Any]:
    """Every process's object on ``dst`` (rank order); the others get []."""
    everyone = all_gather(data)
    return everyone if get_rank() == dst else []


def reduce_dict(d: Dict[str, float], average: bool = True) -> Dict[str, float]:
    """Mean (or sum) of a dict of scalars across processes."""
    world = get_world_size()
    if world == 1:
        return dict(d)
    keys = sorted(d)
    vals = torch.tensor([float(d[k]) for k in keys], dtype=torch.float64,
                        device=_collective_device())
    dist.all_reduce(vals)
    if average:
        vals /= world
    return dict(zip(keys, vals.tolist()))


def shared_random_seed() -> int:
    """A seed drawn on rank 0 and shared by all processes."""
    return int(all_gather(int(np.random.randint(2 ** 31)))[0])


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    dtypes = {t.dtype for t in tensors}
    devices = {t.device for t in tensors}
    if len(dtypes) != 1 or len(devices) != 1:
        raise ValueError(f"one dtype and one device expected, got {dtypes}, {devices}")
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average ``tensors`` (one dtype, one device) over the processes, in
    place, with one all-reduce of their concatenation. Every process ends
    with the same bits."""
    world = get_world_size()
    if world == 1 or not tensors:
        return
    flat = _flat(tensors)
    dist.all_reduce(flat)
    flat /= world
    _unflat_(flat, tensors)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` with rank ``src``'s, one broadcast per dtype."""
    if get_world_size() == 1:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = _flat(group)
        dist.broadcast(flat, src)
        _unflat_(flat, group)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (one shape and dtype on all of them)
    concatenated along dim 0 in rank order, on ``t``'s device."""
    world = get_world_size()
    if world == 1:
        return t
    x = t.to(_collective_device()).contiguous()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    return torch.cat(parts).to(t.device)
