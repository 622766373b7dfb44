"""Training checkpoints (counterpart of ``Checkpointer`` in
``u2seg_tpu/engine/checkpoint.py``; its converters of detectron2 weights have
their way back in ``u2seg_torch/weights.py``).

A checkpoint is one ``torch.save`` file, ``<output_dir>/<name>``, of the
dict the trainer hands over (``{"model": state_dict, "optimizer":
state_dict, "iteration": it}``); ``last_checkpoint`` names the newest. Rank
0 writes, then every process waits at a barrier; every process loads.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Optional, Tuple

import torch

from u2seg_torch.parallel import comm

logger = logging.getLogger(__name__)

LAST_CHECKPOINT = "last_checkpoint"


class Checkpointer:
    """Periodic save / resume_or_load with a ``last_checkpoint`` pointer."""

    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.abspath(os.path.join(self.output_dir, name))

    def _write(self, path: str, write) -> None:
        tmp = f"{path}.{os.getpid()}.tmp"
        write(tmp)
        os.replace(tmp, path)

    def save(self, name: str, state: Any) -> str:
        """Rank 0 writes ``state`` to ``name`` and points ``last_checkpoint``
        at it; every process returns once it is on disk."""
        path = self._path(name)
        if comm.is_main_process():
            self._write(path, lambda p: torch.save(state, p))

            def pointer(p):
                with open(p, "w") as f:
                    f.write(name)

            self._write(os.path.join(self.output_dir, LAST_CHECKPOINT), pointer)
            logger.info("Saved checkpoint to %s", path)
        comm.synchronize()
        return path

    def load(self, name: str, map_location=None) -> Any:
        path = self._path(name)
        state = torch.load(path, map_location=map_location, weights_only=True)
        logger.info("Loaded checkpoint from %s", path)
        return state

    def has_checkpoint(self) -> bool:
        return os.path.exists(os.path.join(self.output_dir, LAST_CHECKPOINT))

    def get_checkpoint_file(self) -> Optional[str]:
        p = os.path.join(self.output_dir, LAST_CHECKPOINT)
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return f.read().strip()

    def resume_or_load(self, target: Any, resume: bool = True,
                       map_location=None) -> Tuple[Any, bool]:
        """(the newest checkpoint, True) when ``resume`` and there is one,
        else (``target``, False)."""
        if resume and self.has_checkpoint():
            return self.load(self.get_checkpoint_file(), map_location), True
        return target, False
