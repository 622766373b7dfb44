"""detectron2-style layers: a conv that owns its norm and activation.

d2's ``layers.Conv2d`` keeps the norm as a ``norm`` submodule of the conv (and
applies an optional activation after it), so its state dict names are
``<conv>.weight`` and ``<conv>.norm.weight``; the port keeps that layout so a
d2 checkpoint loads without renaming.

Parameters stay f32. Like flax's ``dtype=`` on a layer, the forward casts
weight and bias to the dtype of its input, which the model has already cast
to the compute dtype. A layer's ``quantize`` (None unless ``set_quantizer``
gives one) rounds its input, its weight, its product's output and its
norm's output (every tensor the program holds in the compute dtype): the
control computes so in a precision below the configuration's.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


def _operands(layer, x):
    q = getattr(layer, "quantize", None)
    w = layer.weight.to(x.dtype)
    return (x, w) if q is None else (q(x), q(w))


def rounded(layer, y):
    q = getattr(layer, "quantize", None)
    return y if q is None else q(y)


def set_quantizer(model: nn.Module, quantize: Optional[Callable]) -> None:
    """Give every conv and linear layer of ``model`` the rounding
    ``quantize`` of its operands (None: none)."""
    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear)):
            m.quantize = quantize


class Conv2d(nn.Conv2d):
    def __init__(self, *args, norm: Optional[nn.Module] = None,
                 activation: Optional[Callable] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        x, w = _operands(self, x)
        x = rounded(self, F.conv2d(x, w, bias, self.stride,
                                    self.padding, self.dilation, self.groups))
        if self.norm is not None:
            x = rounded(self, self.norm(x))
        if self.activation is not None:
            x = self.activation(x)
        return x


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        x, w = _operands(self, x)
        return rounded(self, F.conv_transpose2d(x, w, bias,
                                                 self.stride, self.padding,
                                                 self.output_padding, self.groups,
                                                 self.dilation))


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        x, w = _operands(self, x)
        return rounded(self, F.linear(x, w, bias))
