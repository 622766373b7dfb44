"""Backbone registry (counterpart of ``u2seg_tpu/models/backbone.py``).

``build_backbone(model_cfg, input_hw)`` looks ``model_cfg.backbone.name`` up
in ``BACKBONE_REGISTRY`` and returns a module mapping normalized NCHW images
to ``{"p<l>": NCHW map}``: ``ResNetFPN``, ``ViTDet`` (ViT +
SimpleFeaturePyramid), and ``SwinFPN``, ``MViTFPN``, ``RegNetFPN`` (a trunk
+ the FPN: ``TrunkFPN``), each with the JAX builder's arguments. ``input_hw``
is the (H, W) that the model is built for: ViTDet's ``pos_embed`` is made
for its token grid (the JAX predictor initialises the model at
``input.pad_buckets[0]``, and ``build_model`` passes that); the other
backbones ignore it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from u2seg_torch.config import ModelConfig
from u2seg_torch.models.fpn import FPN

BACKBONE_REGISTRY: Dict[str, Callable[..., nn.Module]] = {}


def register_backbone(name: str):
    def deco(fn):
        BACKBONE_REGISTRY[name] = fn
        return fn

    return deco


class TrunkFPN(FPN):
    """``TrunkFPN(trunk, fpn_cfg)``: a trunk returning ``res2..res5`` (its
    ``channels`` per level) as ``bottom_up``, followed by the FPN."""


@register_backbone("ResNetFPN")
def _resnet_fpn(c: ModelConfig, input_hw=None) -> nn.Module:
    return FPN(c.resnet, c.fpn)


@register_backbone("ViTDet")
def _vitdet(c: ModelConfig, input_hw=None) -> nn.Module:
    from u2seg_torch.models.vit import ViT, ViTDet

    b = c.backbone
    if input_hw is None:
        raise ValueError("ViTDet: pos_embed is made for one input size; pass input_hw")
    # the token grid of flax's SAME patch conv
    grid = tuple(-(-s // b.vit_patch_size) for s in input_hw)
    dtype = getattr(torch, c.compute_dtype) if b.vit_in_compute_dtype else torch.float32
    trunk = ViT(grid, patch_size=b.vit_patch_size,
                dim=b.vit_dim, depth=b.vit_depth, num_heads=b.vit_num_heads,
                window_size=b.vit_window_size, global_blocks=tuple(b.vit_global_blocks),
                rel_pos=b.vit_use_rel_pos, drop_path_rate=b.vit_drop_path_rate,
                sdpa=b.vit_sdpa, dtype=dtype)
    return ViTDet(trunk, out_channels=c.fpn.out_channels)


@register_backbone("SwinFPN")
def _swin_fpn(c: ModelConfig, input_hw=None) -> nn.Module:
    from u2seg_torch.models.swin import SwinTransformer

    b = c.backbone
    return TrunkFPN(SwinTransformer(embed_dim=b.embed_dim, depths=tuple(b.depths),
                                    num_heads=tuple(b.trunk_num_heads),
                                    window_size=b.window_size), c.fpn)


@register_backbone("MViTFPN")
def _mvit_fpn(c: ModelConfig, input_hw=None) -> nn.Module:
    from u2seg_torch.models.mvit import MViT

    b = c.backbone
    return TrunkFPN(MViT(embed_dim=b.embed_dim, depths=tuple(b.depths),
                         num_heads=tuple(b.trunk_num_heads)), c.fpn)


@register_backbone("RegNetFPN")
def _regnet_fpn(c: ModelConfig, input_hw=None) -> nn.Module:
    from u2seg_torch.models.regnet import RegNet

    b = c.backbone
    return TrunkFPN(RegNet(w_a=b.regnet_w_a, w_0=b.regnet_w_0, w_m=b.regnet_w_m,
                           depth=b.regnet_depth, group_width=b.regnet_group_width,
                           norm=c.resnet.norm), c.fpn)


def build_backbone(model_cfg: ModelConfig,
                   input_hw: Optional[Tuple[int, int]] = None) -> nn.Module:
    name = model_cfg.backbone.name
    if name not in BACKBONE_REGISTRY:
        raise KeyError(f"Unknown backbone: {name}")
    return BACKBONE_REGISTRY[name](model_cfg, input_hw)
