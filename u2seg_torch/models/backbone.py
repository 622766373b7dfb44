"""Backbone construction (counterpart of ``u2seg_tpu/models/backbone.py``).

The port builds the ``ResNetFPN`` entry only; the other trunks of the JAX
package's registry are later slices of the port.
"""
from __future__ import annotations

from torch import nn

from u2seg_torch.config import ModelConfig
from u2seg_torch.models.fpn import FPN


def build_backbone(model_cfg: ModelConfig) -> nn.Module:
    name = model_cfg.backbone.name
    if name != "ResNetFPN":
        raise KeyError(f"backbone {name!r} is not ported yet")
    return FPN(model_cfg.resnet, model_cfg.fpn)
