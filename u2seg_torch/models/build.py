"""Model construction (counterpart of ``u2seg_tpu/models/build.py``).

``META_ARCH_REGISTRY`` maps ``model.meta_architecture`` to a constructor taking
the model config and ``input_hw``, the (H, W) that the model is built for
(``input.pad_buckets[0]``, where the JAX predictor initialises its model:
ViTDet's ``pos_embed`` follows it); ``register_meta_arch`` adds one. The built-in names are
the JAX package's six: PanopticFPN, GeneralizedRCNN, ProposalNetwork,
SemanticSegmentor, RetinaNet and FCOS.

``build_model`` runs on ``cuda`` unless the caller passes ``device="cpu"``
(or another explicit device); with no GPU and no explicit device it raises
instead of carrying on on the CPU.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch
from torch import nn

from u2seg_torch.config import Config, ModelConfig

META_ARCH_REGISTRY: Dict[str, Callable[[ModelConfig], nn.Module]] = {}


def register_meta_arch(name: str):
    def deco(cls):
        META_ARCH_REGISTRY[name] = cls
        return cls

    return deco


def _register_builtin() -> None:
    from u2seg_torch.models.dense_detector import FCOSDetector, RetinaNetDetector
    from u2seg_torch.models.panoptic_fpn import PanopticFPN
    from u2seg_torch.models.rcnn import (GeneralizedRCNN, ProposalNetwork,
                                         SemanticSegmentor)

    for name, cls in (("PanopticFPN", PanopticFPN), ("GeneralizedRCNN", GeneralizedRCNN),
                      ("ProposalNetwork", ProposalNetwork),
                      ("SemanticSegmentor", SemanticSegmentor),
                      ("RetinaNet", RetinaNetDetector), ("FCOS", FCOSDetector)):
        META_ARCH_REGISTRY.setdefault(name, cls)


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return dev


def build_model(cfg: Config, device: Optional[Union[str, torch.device]] = None,
                seed: int = 0) -> nn.Module:
    """cfg -> the ``model.meta_architecture`` module in eval mode on
    ``device``, its weights drawn by the port's seeded init
    (``u2seg_torch.weights.seeded_init``)."""
    from u2seg_torch.weights import seeded_init

    dev = resolve_device(device)
    name = cfg.model.meta_architecture
    if name not in META_ARCH_REGISTRY:
        _register_builtin()
    if name not in META_ARCH_REGISTRY:
        raise KeyError(f"Unknown meta architecture: {name}")
    model = META_ARCH_REGISTRY[name](cfg.model, input_hw=tuple(cfg.input.pad_buckets[0]))
    seeded_init(model, seed)
    return model.to(dev).eval()
