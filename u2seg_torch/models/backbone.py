"""Backbone registry (counterpart of ``u2seg_tpu/models/backbone.py``).

``build_backbone(model_cfg)`` looks ``model_cfg.backbone.name`` up in
``BACKBONE_REGISTRY`` and returns a module mapping normalized NCHW images to
``{"p<l>": NCHW map}``. The port registers ``ResNetFPN``; the JAX package's
other trunks (``ViTDet``, ``SwinFPN``, ``MViTFPN``, ``RegNetFPN``) are named
here and raise ``KeyError`` until they are ported.
"""
from __future__ import annotations

from typing import Callable, Dict

from torch import nn

from u2seg_torch.config import ModelConfig
from u2seg_torch.models.fpn import FPN

BACKBONE_REGISTRY: Dict[str, Callable[[ModelConfig], nn.Module]] = {}
NOT_PORTED = ("ViTDet", "SwinFPN", "MViTFPN", "RegNetFPN")


def register_backbone(name: str):
    def deco(fn):
        BACKBONE_REGISTRY[name] = fn
        return fn

    return deco


@register_backbone("ResNetFPN")
def _resnet_fpn(c: ModelConfig) -> nn.Module:
    return FPN(c.resnet, c.fpn)


def build_backbone(model_cfg: ModelConfig) -> nn.Module:
    name = model_cfg.backbone.name
    if name not in BACKBONE_REGISTRY:
        if name in NOT_PORTED:
            raise KeyError(f"backbone {name!r} is not ported yet")
        raise KeyError(f"Unknown backbone: {name}")
    return BACKBONE_REGISTRY[name](model_cfg)
