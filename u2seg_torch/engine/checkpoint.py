"""Training checkpoints (counterpart of ``Checkpointer`` in
``u2seg_tpu/engine/checkpoint.py``; its converters of detectron2 weights have
their way back in ``u2seg_torch/weights.py``).

A checkpoint is one ``torch.save`` file, ``<output_dir>/<name>``, of the
dict the trainer hands over (``{"model": state_dict, "optimizer":
state_dict, "iteration": it}``); ``last_checkpoint`` names the newest. Rank
0 writes, then every process waits at a barrier; every process loads.

``load_model_weights`` loads ``model.weights`` into a model: a port
checkpoint, or a detectron2 PanopticFPN state dict (``.pkl`` or ``.pth``) in
the names the port's modules carry.
"""
from __future__ import annotations

import logging
import os
import pickle
from typing import Any, Dict, Optional, Tuple

import numpy as np
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


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A detectron2 ``.pkl`` (numpy arrays under ``model``) or a torch file
    (a port checkpoint, or a ``.pth`` with ``model`` / ``state_dict``) ->
    flat name -> CPU tensor dict."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
    else:
        data = torch.load(path, map_location="cpu", weights_only=True)
    model = data.get("model", data.get("state_dict", data))
    return {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
            for k, v in model.items() if hasattr(v, "shape")}


# detectron2 state dicts carry these, the port's modules do not: torch BN's
# step counters, and the pixel statistics the port takes from its config
_BOOKKEEPING = ("num_batches_tracked",)
_PIXEL_STATS = ("pixel_mean", "pixel_std")


def load_model_weights(model: torch.nn.Module, path: str) -> Dict[str, list]:
    """Copy the tensors of ``path`` into ``model``'s parameters and buffers.
    Logs how many loaded and which of the model's names the file lacks.
    Raises on a shape mismatch, on a name the model lacks (BN step counters
    aside) and on pixel statistics that differ from the model's config.
    Returns {"loaded": names, "missing": names}."""
    ref = load_reference_state_dict(path)
    own = model.state_dict()
    unknown, mismatched, loaded = [], [], []
    for name, value in ref.items():
        if name.endswith(_BOOKKEEPING):
            continue
        if name in _PIXEL_STATS:
            want = torch.tensor(getattr(model.cfg, name), dtype=torch.float64)
            if not torch.allclose(value.double().flatten(), want):
                raise ValueError(f"{path}: {name} {value.flatten().tolist()} differs from "
                                 f"the config's {want.tolist()}")
            continue
        if name not in own:
            unknown.append(name)
        elif tuple(value.shape) != tuple(own[name].shape):
            mismatched.append(f"{name}: {tuple(value.shape)} vs {tuple(own[name].shape)}")
        else:
            loaded.append(name)
    if unknown or mismatched:
        raise ValueError(f"{path} does not fit the model: names it lacks "
                         f"{unknown[:8]}{' ...' if len(unknown) > 8 else ''} "
                         f"({len(unknown)}), shape mismatches {mismatched[:8]} "
                         f"({len(mismatched)})")
    with torch.no_grad():
        for name in loaded:
            own[name].copy_(ref[name].to(own[name].dtype))
    missing = sorted(set(own) - set(loaded))
    logger.info("Loaded %d of %d model tensors from %s", len(loaded), len(own), path)
    if missing:
        logger.warning("The model keeps its initial values for %d tensors the file "
                       "lacks: %s%s", len(missing), missing[:16],
                       " ..." if len(missing) > 16 else "")
    return {"loaded": loaded, "missing": missing}
