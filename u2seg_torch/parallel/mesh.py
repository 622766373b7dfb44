"""The data-parallel layout (counterpart of ``u2seg_tpu/parallel/mesh.py``).

The JAX package splits a global batch over the ``data`` axis of a device
mesh. The port's stand-in is the default process group: ``Mesh`` records the
world size, this process's rank and its device, and ``shard_batch`` takes
this rank's contiguous slice of a global batch, as ``shard_map`` splits
``P("data")``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from u2seg_torch.engine.trainer import Batch
from u2seg_torch.models.build import resolve_device
from u2seg_torch.parallel import comm


@dataclasses.dataclass(frozen=True)
class Mesh:
    world_size: int
    rank: int
    device: torch.device


def create_mesh(device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """This process's place in the default group (1 process when there is
    none) and its device: ``cuda`` (the current card) unless the caller
    names another; with no GPU and no explicit device it raises."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(comm.get_world_size(), comm.get_rank(), dev)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    assert global_batch % mesh.world_size == 0, (global_batch, mesh.world_size)
    return global_batch // mesh.world_size


def shard_batch(mesh: Mesh, batch: Batch) -> Batch:
    """This rank's rows ``[rank * b/N, (rank + 1) * b/N)`` of a global
    ``Batch``, on the rank's device."""
    n = local_batch_size(batch.images.shape[0], mesh)
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    local = Batch(batch.images[rows], batch.image_sizes[rows], batch.gt[rows],
                  batch.sem_seg[rows])
    return local.to(mesh.device)
