"""TridentNet: scale-aware parallel dilated branches (counterpart of
``u2seg_tpu/projects/tridentnet.py``; detectron2's ``projects/TridentNet``).

A trident block runs one 3x3 kernel at several dilations, one branch per
scale range. The 1x1 convs ``conv1`` and ``conv3`` are shared by the
branches; the norms and the ``shortcut{i}`` projections belong to each
branch. NCHW tensors.

``norms`` holds the block's norms in the order flax numbers them: the
``conv1`` norm of each branch first, then for branch i its mid norm (after
the trident conv) at ``n + 2i`` and its out norm (after ``conv3``) at ``n +
2i + 1``, n the number of branches.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from u2seg_torch.models.layers import Conv2d
from u2seg_torch.ops.norms import get_norm


class TridentConv(nn.Conv2d):
    """One ``weight`` applied at each of ``dilations`` with padding
    ``d * (k - 1) // 2``: one input per branch in, one output per branch
    out."""

    def __init__(self, in_channels: int, features: int,
                 dilations: Tuple[int, ...] = (1, 2, 3), kernel_size: int = 3):
        super().__init__(in_channels, features, kernel_size, bias=False)
        self.dilations = tuple(dilations)

    def forward(self, branches: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        k = self.kernel_size[0]
        return tuple(F.conv2d(x, self.weight.to(x.dtype), None, 1, d * (k - 1) // 2, d)
                     for x, d in zip(branches, self.dilations))


class TridentBlock(nn.Module):
    """Bottleneck block with a trident 3x3 (shared across branches)."""

    def __init__(self, in_channels: int, out_channels: int, bottleneck_channels: int,
                 dilations: Tuple[int, ...] = (1, 2, 3), norm: str = "BN"):
        super().__init__()
        n = len(dilations)
        self.conv1 = Conv2d(in_channels, bottleneck_channels, 1, bias=False)
        self.conv3 = Conv2d(bottleneck_channels, out_channels, 1, bias=False)
        self.trident = TridentConv(bottleneck_channels, bottleneck_channels, dilations)
        if in_channels != out_channels:
            for i in range(n):
                self.add_module(f"shortcut{i}", Conv2d(in_channels, out_channels, 1, bias=False))
        widths = [bottleneck_channels] * n + [bottleneck_channels, out_channels] * n
        self.norms = nn.ModuleList([get_norm(norm, c) for c in widths])

    def forward(self, branches: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        n = len(branches)
        mid = [F.relu(self.norms[i](self.conv1(b))) for i, b in enumerate(branches)]
        mid = self.trident(mid)
        outs = []
        for i, (b, m) in enumerate(zip(branches, mid)):
            m = F.relu(self.norms[n + 2 * i](m))
            m = self.norms[n + 2 * i + 1](self.conv3(m))
            if hasattr(self, f"shortcut{i}"):
                b = getattr(self, f"shortcut{i}")(b)
            outs.append(F.relu(b + m))
        return tuple(outs)


class TridentStage(nn.Module):
    """``trident_block0`` ... ``trident_block{num_blocks - 1}`` over three
    copies of one input feature."""

    def __init__(self, in_channels: int, num_blocks: int, out_channels: int,
                 bottleneck_channels: int, **kwargs):
        super().__init__()
        self.num_blocks = num_blocks
        self.num_branches = len(kwargs.get("dilations", (1, 2, 3)))
        for i in range(num_blocks):
            self.add_module(f"trident_block{i}", TridentBlock(
                in_channels if i == 0 else out_channels, out_channels,
                bottleneck_channels, **kwargs))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        branches = (x,) * self.num_branches
        for i in range(self.num_blocks):
            branches = getattr(self, f"trident_block{i}")(branches)
        return branches


def make_trident_stage(in_channels: int, num_blocks: int, out_channels: int,
                       bottleneck_channels: int, **kwargs) -> TridentStage:
    """The stage the JAX package's ``make_trident_stage`` builds in its
    caller's scope (``trident_block{i}``), as a module."""
    return TridentStage(in_channels, num_blocks, out_channels, bottleneck_channels, **kwargs)
