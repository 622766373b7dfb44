"""Deformable convolution v1 / v2 (counterpart of
``u2seg_tpu/ops/deform_conv.py``; detectron2's ``layers/deform_conv.py``).

NCHW. Deformable im2col is a bilinear gather of the K*K taps at (grid +
learned offset), then one matmul with the weights. Offsets are (dy, dx)
per tap, tap-major (channel ``2 * tap + {0: dy, 1: dx}``); a corner outside
the map reads zero (floor corner plus one, no clamping into the map). The
backward is autograd of the gather (scatter-add into the features, the
bilinear weights' derivative into the offsets), as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from u2seg_torch.models.layers import Conv2d


def _bilinear_gather(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """x: (B, C, H, W); ys, xs: (B, P) sample coordinates -> (B, C, P),
    zero outside."""
    b, c, h, w = x.shape
    flat = x.reshape(b, c, h * w)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    out = 0.0
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            yy, xx = y0 + dy, x0 + dx
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            lin = (torch.clamp(yy, 0, h - 1).to(torch.int64) * w
                   + torch.clamp(xx, 0, w - 1).to(torch.int64))
            v = torch.gather(flat, 2, lin[:, None, :].expand(b, c, lin.shape[1]))
            out = out + v * (wy * wx * inside)[:, None, :]
    return out


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                  stride: int = 1, padding: int = 1, dilation: int = 1,
                  mask: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deformable conv forward. x (B, Cin, H, W), offsets (B, 2*K*K, Ho,
    Wo), weight (Cout, Cin, K, K), mask (B, K*K, Ho, Wo) for v2 ->
    (B, Cout, Ho, Wo), ``Ho = (H + 2p - d*(K-1) - 1) // s + 1``."""
    b, cin, h, w = x.shape
    k = weight.shape[-1]
    ho = (h + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    dev = x.device
    oy = (torch.arange(ho, device=dev) * stride - padding).to(x.dtype)
    ox = (torch.arange(wo, device=dev) * stride - padding).to(x.dtype)
    taps = (torch.arange(k, device=dev) * dilation).to(x.dtype)
    ky, kx = torch.meshgrid(taps, taps, indexing="ij")
    base_y = ky.reshape(-1)[:, None, None] + oy[None, :, None]         # (KK, Ho, 1)
    base_x = kx.reshape(-1)[:, None, None] + ox[None, None, :]         # (KK, 1, Wo)
    off = offsets.reshape(b, k * k, 2, ho, wo)
    ys = (base_y[None] + off[:, :, 0]).reshape(b, -1)                  # (B, KK*Ho*Wo)
    xs = (base_x[None] + off[:, :, 1]).reshape(b, -1)
    sampled = _bilinear_gather(x, ys, xs).reshape(b, cin, k * k, ho * wo)
    if mask is not None:
        sampled = sampled * mask.reshape(b, 1, k * k, ho * wo)
    out = torch.matmul(weight.reshape(weight.shape[0], cin * k * k),
                       sampled.reshape(b, cin * k * k, ho * wo))
    out = out.reshape(b, -1, ho, wo)
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1)
    return out


class DeformConv(nn.Module):
    """v1: offsets from a plain conv branch (``offset_conv``, zero init) or
    given by the caller."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.offset_conv = Conv2d(in_channels, 2 * k * k, k, stride=stride, padding=padding)
        self.weight = nn.Parameter(torch.empty(features, in_channels, k, k))
        reset_deform_parameters(self)

    def forward(self, x: torch.Tensor, offsets: Optional[torch.Tensor] = None):
        if offsets is None:
            offsets = self.offset_conv(x)
        return deform_conv2d(x, offsets, self.weight, self.stride, self.padding,
                             self.dilation)


class ModulatedDeformConv(nn.Module):
    """v2: offsets and a modulation mask ``2 * sigmoid(.)`` from one conv
    branch (``offset_mask_conv``, zero init), and a bias."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.offset_mask_conv = Conv2d(in_channels, 3 * k * k, k, stride=stride,
                                       padding=padding)
        self.weight = nn.Parameter(torch.empty(features, in_channels, k, k))
        self.bias = nn.Parameter(torch.zeros(features))
        reset_deform_parameters(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kk = self.weight.shape[-1] ** 2
        om = self.offset_mask_conv(x)
        mask = torch.sigmoid(om[:, 2 * kk:]) * 2.0
        return deform_conv2d(x, om[:, :2 * kk], self.weight, self.stride, self.padding,
                             self.dilation, mask=mask, bias=self.bias)


@torch.no_grad()
def reset_deform_parameters(mod: nn.Module, generator: Optional[torch.Generator] = None):
    """The JAX package's init: the kernel variance_scaling(2.0, "fan_out",
    "normal") (fan_out = Cout * K * K), the offset branch and the bias zero."""
    w = mod.weight
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    w.copy_(torch.randn(w.shape, generator=generator) * math.sqrt(2.0 / fan_out))
    branch = getattr(mod, "offset_conv", None) or getattr(mod, "offset_mask_conv")
    branch.weight.zero_()
    branch.bias.zero_()
    if getattr(mod, "bias", None) is not None:
        mod.bias.zero_()
