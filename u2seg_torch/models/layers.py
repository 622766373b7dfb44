"""detectron2-style layers: a conv that owns its norm and activation.

d2's ``layers.Conv2d`` keeps the norm as a ``norm`` submodule of the conv (and
applies an optional activation after it), so its state dict names are
``<conv>.weight`` and ``<conv>.norm.weight``; the port keeps that layout so a
d2 checkpoint loads without renaming.

Parameters stay f32. Like flax's ``dtype=`` on a layer, the forward casts
weight and bias to the dtype of its input, which the model has already cast
to the compute dtype.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    def __init__(self, *args, norm: Optional[nn.Module] = None,
                 activation: Optional[Callable] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        x = F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                     self.padding, self.dilation, self.groups)
        if self.norm is not None:
            x = self.norm(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)
