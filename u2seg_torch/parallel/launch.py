"""Process-group set-up (counterpart of ``u2seg_tpu/parallel/launch.py``).

``launch`` initialises ``torch.distributed``'s default group from its
arguments or from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` / ``MASTER_PORT``, ``LOCAL_RANK``), calls the main function,
and destroys the group when it returns or raises. Nothing distributed asked
for: it only calls the function.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# Gloo's default bootstrap deadline (30 s) is shorter than a cold start of
# several processes that import torch and build CUDA kernels at once.
TIMEOUT = datetime.timedelta(minutes=10)


def launch(
    main_func: Callable,
    *,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    args: tuple = (),
):
    """Run ``main_func(*args)`` inside a default process group.

    ``init_method`` is a rendezvous URL (``file://...``, ``tcp://host:port``;
    default ``env://``, which reads ``MASTER_ADDR`` / ``MASTER_PORT``).
    ``backend`` defaults to ``nccl`` where there is a CUDA device and
    ``gloo`` otherwise; under ``nccl`` each process takes the card
    ``LOCAL_RANK`` (default: its rank modulo the cards it sees).
    """
    env = os.environ
    if world_size is None and init_method is None and "WORLD_SIZE" not in env:
        return main_func(*args)
    world = world_size if world_size is not None else int(env.get("WORLD_SIZE", "1"))
    rank = rank if rank is not None else int(env.get("RANK", "0"))
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    logger.info("process %d/%d, backend %s", rank, world, backend)
    try:
        return main_func(*args)
    finally:
        dist.destroy_process_group()
