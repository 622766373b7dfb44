"""Feature Pyramid Network (counterpart of ``u2seg_tpu/models/fpn.py``).

detectron2's layout: the backbone module owns ``bottom_up`` and the
``fpn_lateral{2..5}`` / ``fpn_output{2..5}`` convs (each with ``.norm``).
``bottom_up`` is the ResNet of a ``ResNetConfig``, or a trunk module with
its per-level ``channels`` (``TrunkFPN``: RegNet, Swin, MViT). The pyramid
computes in the dtype of its input image: a trunk that computes in f32
(the JAX package builds the trunks with no dtype) hands its levels back in
that dtype, as the JAX FPN's ``dtype`` casts them.
Top-down: lateral 1x1 + nearest 2x upsample of the coarser result (summed,
or with ``fuse_type="avg"`` averaged), 3x3 output conv. The top block makes
the next level from the coarsest output: ``maxpool`` a stride-2 max-pool
(kernel 1), ``p6p7`` (RetinaNet, FCOS) ``p6 = conv3x3/2(p5)`` and ``p7 =
conv3x3/2(relu(p6))`` as ``top_block.p6`` / ``.p7``. Those two convs run in
f32 whatever the compute dtype: the JAX package gives them no ``dtype``, so
flax promotes their bf16 input to the f32 of their parameters.
"""
from __future__ import annotations

from typing import Dict, Union

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


class LastLevelP6P7(nn.Module):
    """p6 and p7 from the coarsest FPN output, in f32."""

    def __init__(self, channels: int):
        super().__init__()
        self.p6 = Conv2d(channels, channels, 3, stride=2, padding=1)
        self.p7 = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor):
        p6 = self.p6(x.float())
        return p6, self.p7(F.relu(p6))


class FPN(nn.Module):
    """Bottom-up (a ResNet, or a trunk module returning ``res2..res5`` with
    its ``channels``) + FPN; returns {"p<l>": NCHW map} from the finest
    input level to the top block's."""

    def __init__(self, bottom_up: Union[ResNetConfig, nn.Module], cfg: FPNConfig):
        super().__init__()
        if cfg.top_block not in ("maxpool", "p6p7") or cfg.fuse_type not in ("sum", "avg"):
            raise ValueError(f"unknown FPN top block {cfg.top_block!r} or "
                             f"fuse type {cfg.fuse_type!r}")
        if isinstance(bottom_up, ResNetConfig):
            self.bottom_up = ResNet(bottom_up)
            chans = feature_channels(bottom_up)
        else:
            self.bottom_up = bottom_up
            chans = bottom_up.channels
        self.in_features = tuple(cfg.in_features)
        self.fuse_avg = cfg.fuse_type == "avg"
        use_bias = cfg.norm == ""
        for name in self.in_features:
            lvl = FEATURE_STRIDES[name].bit_length() - 1
            self.add_module(f"fpn_lateral{lvl}", Conv2d(
                chans[name], cfg.out_channels, 1, bias=use_bias,
                norm=get_norm(cfg.norm, cfg.out_channels)))
            self.add_module(f"fpn_output{lvl}", Conv2d(
                cfg.out_channels, cfg.out_channels, 3, padding=1,
                bias=use_bias, norm=get_norm(cfg.norm, cfg.out_channels)))
        if cfg.top_block == "p6p7":
            self.top_block = LastLevelP6P7(cfg.out_channels)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        bottom_up = self.bottom_up(x)
        out: Dict[str, torch.Tensor] = {}
        prev = None
        for name in reversed(self.in_features):
            lvl = FEATURE_STRIDES[name].bit_length() - 1
            lateral = getattr(self, f"fpn_lateral{lvl}")(bottom_up[name].to(x.dtype))
            if prev is not None:
                lateral = lateral + _upsample2x(prev)
                if self.fuse_avg:
                    lateral = lateral / 2.0
            prev = lateral
            out[f"p{lvl}"] = getattr(self, f"fpn_output{lvl}")(lateral)
        top = FEATURE_STRIDES[self.in_features[-1]].bit_length() - 1
        if hasattr(self, "top_block"):
            out[f"p{top + 1}"], out[f"p{top + 2}"] = self.top_block(out[f"p{top}"])
        else:
            out[f"p{top + 1}"] = out[f"p{top}"][:, :, ::2, ::2]
        return {k: out[k] for k in sorted(out, key=lambda k: int(k[1:]))}
