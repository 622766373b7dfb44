"""Feature Pyramid Network (counterpart of ``u2seg_tpu/models/fpn.py``).

detectron2's layout: the backbone module owns ``bottom_up`` and the
``fpn_lateral{2..5}`` / ``fpn_output{2..5}`` convs (each with ``.norm``).
Top-down: lateral 1x1 + nearest 2x upsample of the coarser result, 3x3
output conv; p6 is a stride-2 max-pool (kernel 1) of p5.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from u2seg_torch.config import FPNConfig, ResNetConfig
from u2seg_torch.models.layers import Conv2d
from u2seg_torch.models.resnet import FEATURE_STRIDES, ResNet, feature_channels
from u2seg_torch.ops.norms import get_norm

FPN_STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64, "p7": 128}


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor (keeps its memory
    format; source index floor(i * 0.5) is exact)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class FPN(nn.Module):
    """ResNet bottom-up + FPN; returns {"p2".."p6"} NCHW maps."""

    def __init__(self, resnet_cfg: ResNetConfig, cfg: FPNConfig):
        super().__init__()
        if cfg.top_block != "maxpool" or cfg.fuse_type != "sum":
            raise NotImplementedError(
                "the port builds the max-pool top block with sum fusion")
        self.bottom_up = ResNet(resnet_cfg)
        self.in_features = tuple(cfg.in_features)
        chans = feature_channels(resnet_cfg)
        use_bias = cfg.norm == ""
        for name in self.in_features:
            lvl = FEATURE_STRIDES[name].bit_length() - 1
            self.add_module(f"fpn_lateral{lvl}", Conv2d(
                chans[name], cfg.out_channels, 1, bias=use_bias,
                norm=get_norm(cfg.norm, cfg.out_channels)))
            self.add_module(f"fpn_output{lvl}", Conv2d(
                cfg.out_channels, cfg.out_channels, 3, padding=1,
                bias=use_bias, norm=get_norm(cfg.norm, cfg.out_channels)))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        bottom_up = self.bottom_up(x)
        out: Dict[str, torch.Tensor] = {}
        prev = None
        for name in reversed(self.in_features):
            lvl = FEATURE_STRIDES[name].bit_length() - 1
            lateral = getattr(self, f"fpn_lateral{lvl}")(bottom_up[name])
            if prev is not None:
                lateral = lateral + _upsample2x(prev)
            prev = lateral
            out[f"p{lvl}"] = getattr(self, f"fpn_output{lvl}")(lateral)
        last = f"p{FEATURE_STRIDES[self.in_features[-1]].bit_length() - 1}"
        out[f"p{int(last[1:]) + 1}"] = out[last][:, :, ::2, ::2]
        return {k: out[k] for k in sorted(out, key=lambda k: int(k[1:]))}
