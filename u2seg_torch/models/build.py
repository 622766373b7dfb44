"""Model construction (counterpart of ``u2seg_tpu/models/build.py``).

``build_model`` runs on ``cuda`` unless the caller passes ``device="cpu"``
(or another explicit device); with no GPU and no explicit device it raises
instead of carrying on on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from u2seg_torch.config import Config
from u2seg_torch.models.panoptic_fpn import PanopticFPN


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def build_model(cfg: Config, device: Optional[Union[str, torch.device]] = None,
                seed: int = 0) -> PanopticFPN:
    """cfg -> PanopticFPN in eval mode on ``device``, its weights drawn by
    the port's seeded init (``u2seg_torch.weights.seeded_init``)."""
    from u2seg_torch.weights import seeded_init

    dev = resolve_device(device)
    name = cfg.model.meta_architecture
    if name != "PanopticFPN":
        raise KeyError(f"meta architecture {name!r} is not ported yet")
    model = PanopticFPN(cfg.model)
    seeded_init(model, seed)
    return model.to(dev).eval()
