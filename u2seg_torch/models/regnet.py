"""RegNet trunk (counterpart of ``u2seg_tpu/models/regnet.py``).

RegNetX: a stride-2 3x3 stem and four stages of residual bottleneck blocks
with grouped 3x3 convs; per-stage widths and depths from the quantized
linear schedule (w_a, w_0, w_m, depth). Names: ``stem``, ``s{k}.{i}.a`` /
``.b`` / ``.c`` / ``.proj``, each conv with its ``.norm``.

The trunk computes in f32 whatever its input's dtype: the JAX package builds
it with no dtype, so flax promotes a bf16 image to its f32 parameters. The
grouped convs are cuDNN's: the JAX package computes them in XLA, not in a
Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from u2seg_torch.models.layers import Conv2d
from u2seg_torch.ops.norms import get_norm


def generate_regnet_params(w_a: float, w_0: int, w_m: float, depth: int,
                           q: int = 8, group_width: int = 1,
                           bottleneck_ratio: float = 1.0):
    """Per-stage (widths, depths, group_widths): pycls's ``generate_regnet``
    and ``adjust_block_compatibility`` (each stage's bottleneck width a
    multiple of its group width, the group width at most that width)."""
    ws_cont = w_0 + w_a * np.arange(depth)
    ks = np.round(np.log(ws_cont / w_0) / np.log(w_m))
    ws_all = w_0 * np.power(w_m, ks)
    ws_all = np.round(ws_all / q) * q
    widths, depths = np.unique(ws_all.astype(int), return_counts=True)
    order = np.argsort(widths)
    widths, depths = widths[order].tolist(), depths[order].tolist()
    adj_ws, gws = [], []
    for w in widths:
        v = max(1, int(round(w * bottleneck_ratio)))
        g = min(group_width, v)
        v = max(g, int(round(v / g)) * g)
        adj_ws.append(int(round(v / bottleneck_ratio)))
        gws.append(g)
    return adj_ws, depths, gws


class _Block(nn.Module):
    """1x1 -> grouped 3x3 (stride) -> 1x1, with a projected shortcut where
    the width or the stride changes."""

    def __init__(self, in_channels: int, width: int, stride: int,
                 group_width: int, norm: str, bottleneck_ratio: float = 1.0):
        super().__init__()
        w_b = int(round(width * bottleneck_ratio))
        groups = max(w_b // group_width, 1)
        self.a = Conv2d(in_channels, w_b, 1, bias=False, norm=get_norm(norm, w_b))
        self.b = Conv2d(w_b, w_b, 3, stride=stride, padding=1, groups=groups,
                        bias=False, norm=get_norm(norm, w_b))
        self.c = Conv2d(w_b, width, 1, bias=False, norm=get_norm(norm, width))
        if in_channels != width or stride != 1:
            self.proj = Conv2d(in_channels, width, 1, stride=stride, bias=False,
                               norm=get_norm(norm, width))
        else:
            self.proj = None

    def forward(self, x):
        out = self.c(F.relu(self.b(F.relu(self.a(x)))))
        return F.relu(out + (x if self.proj is None else self.proj(x)))


class RegNet(nn.Module):
    """RegNetX (defaults: 4.0GF) returning {"res2".."res5"} NCHW maps in
    channels-last memory, f32; ``channels`` gives each level's width."""

    def __init__(self, w_a: float = 38.65, w_0: int = 96, w_m: float = 2.43,
                 depth: int = 23, group_width: int = 40, stem_width: int = 32,
                 norm: str = "SyncBN",
                 out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")):
        super().__init__()
        widths, depths, gws = generate_regnet_params(
            w_a, w_0, w_m, depth, group_width=group_width)
        self.out_features = tuple(out_features)
        self.stem = Conv2d(3, stem_width, 3, stride=2, padding=1, bias=False,
                           norm=get_norm(norm, stem_width))
        self.channels: Dict[str, int] = {}
        in_ch = stem_width
        for k, (w, d, gw) in enumerate(zip(widths, depths, gws)):
            blocks = []
            for i in range(d):
                blocks.append(_Block(in_ch, w, 2 if i == 0 else 1, gw, norm))
                in_ch = w
            self.add_module(f"s{k + 1}", nn.Sequential(*blocks))
            self.channels[f"res{k + 2}"] = w
        self.num_stages = len(widths)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.relu(self.stem(x.float()))
        out = {}
        for k in range(self.num_stages):
            x = getattr(self, f"s{k + 1}")(x)
            if f"res{k + 2}" in self.out_features:
                out[f"res{k + 2}"] = x
        return out
