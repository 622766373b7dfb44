"""Semantic segmentation FPN head (counterpart of
``u2seg_tpu/models/sem_seg.py``).

Per-level scale heads (3x3 conv + GN + relu, exact 2x bilinear upsamples down
to the common stride), summed, then a 1x1 predictor; logits stay at the
common stride (B, H/4, W/4, C) in f32. The training loss upsamples them to
the input resolution (exact 4x bilinear) and takes the pixel cross-entropy
with an ignore label. detectron2 names: ``p4.0`` / ``p4.2``
(convs at even Sequential slots, upsamples between), each conv with ``.norm``.

GN epsilon is 1e-6: the JAX package builds this GroupNorm with flax's default
epsilon (d2 uses 1e-5), and the port follows the JAX package.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from portbench.refmodel.config import SemSegHeadConfig
from portbench.refmodel.fpn import FPN_STRIDES
from portbench.refmodel.layers import Conv2d
from portbench.refmodel import losses as L
from portbench.refmodel.norms import GroupNorm

SEM_SEG_GN_EPS = 1e-6


def _upnx_axis(x: torch.Tensor, axis: int, s: int) -> torch.Tensor:
    """Exact integer-scale half-pixel bilinear upsample along one axis
    (edge-clamped): output i samples input (i + 0.5)/s - 0.5, so each of the
    s phases is a fixed two-tap stencil of (previous, self) or (self, next)."""
    n = x.shape[axis]
    lo = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)
    hi = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
    phases = []
    for p in range(s):
        o = (p + 0.5) / s - 0.5
        if o < 0:
            phases.append((-o) * lo + (1.0 + o) * x)
        else:
            phases.append((1.0 - o) * x + o * hi)
    stacked = torch.stack(phases, dim=axis + 1)         # (..., n, s, ...)
    shape = list(x.shape)
    shape[axis] = s * n
    return stacked.reshape(shape)


def upsample_bilinear(x: torch.Tensor, s: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, sH, sW) exact bilinear integer upsample."""
    return _upnx_axis(_upnx_axis(x, 2, s), 3, s)


class Upsample2x(nn.Module):
    """Exact 2x bilinear upsample in d2's ``nn.Upsample`` slot of a scale
    head, so the conv indices match d2's."""

    def forward(self, x):
        return upsample_bilinear(x, 2)


class SemSegFPNHead(nn.Module):
    def __init__(self, cfg: SemSegHeadConfig, in_channels: int):
        super().__init__()
        self.cfg = cfg
        if cfg.norm not in ("GN", ""):
            raise NotImplementedError(f"sem-seg norm {cfg.norm!r}")
        for name in cfg.in_features:
            stride = FPN_STRIDES[name]
            head_length = max(1, int(math.log2(stride) - math.log2(cfg.common_stride)))
            ops = []
            for k in range(head_length):
                norm = (GroupNorm(32, cfg.conv_dim, eps=SEM_SEG_GN_EPS)
                        if cfg.norm == "GN" else None)
                ops.append(Conv2d(in_channels if k == 0 else cfg.conv_dim,
                                  cfg.conv_dim, 3, padding=1,
                                  bias=cfg.norm == "", norm=norm,
                                  activation=F.relu))
                if stride != cfg.common_stride:
                    ops.append(Upsample2x())
                    stride //= 2
            self.add_module(name, nn.Sequential(*ops))
        self.predictor = Conv2d(cfg.conv_dim, cfg.num_classes, 1)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        summed = None
        for name in self.cfg.in_features:
            x = getattr(self, name)(features[name])
            summed = x if summed is None else summed + x
        logits = self.predictor(summed).float()
        return logits.permute(0, 2, 3, 1)                # (B, H/4, W/4, C)


    def losses(self, logits: torch.Tensor,
               targets: torch.Tensor) -> Dict[str, torch.Tensor]:
        """logits: (B, H/4, W/4, C) f32 from ``forward``; targets: (B, H, W)
        int labels, ``ignore_value`` = ignore. The loss at full resolution."""
        c = self.cfg
        full = upsample_bilinear(logits.permute(0, 3, 1, 2), c.common_stride)
        loss = L.softmax_ce_ignore(full.permute(0, 2, 3, 1), targets,
                                   c.ignore_value)
        return {"loss_sem_seg": loss * c.loss_weight}
