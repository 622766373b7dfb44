"""The seeded init of the port (``weights.seeded_init``) for the modules of
the R50-FPN Panoptic FPN: every weight drawn, in module order, from a CPU
generator seeded with ``seed``, by the JAX package's initializer for that
layer (biases zero, norms identity). The same seed gives the port's numbers
on any machine."""
from __future__ import annotations

import math

import torch
from torch import nn

from portbench.refmodel.layers import Linear
from portbench.refmodel.norms import BatchNorm2d, GroupNorm


def _fans(weight: torch.Tensor, transposed: bool = False):
    """(fan_in, fan_out) as flax's variance_scaling counts them."""
    if weight.dim() == 2:                          # Linear (out, in)
        return weight.shape[1], weight.shape[0]
    rf = math.prod(weight.shape[2:])
    cin, cout = weight.shape[0], weight.shape[1]
    if not transposed:                             # Conv2d (out, in, kh, kw)
        cin, cout = cout, cin
    return cin * rf, cout * rf


def seeded_init(model: nn.Module, seed: int = 0) -> nn.Module:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (BatchNorm2d, GroupNorm, nn.LayerNorm)):
                mod.weight.fill_(1.0)
                mod.bias.fill_(0.0)
                if isinstance(mod, BatchNorm2d):
                    mod.running_mean.fill_(0.0)
                    mod.running_var.fill_(1.0)
                continue
            if not isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                continue
            w = mod.weight
            fan_in, fan_out = _fans(w, isinstance(mod, nn.ConvTranspose2d))
            if name.startswith(("proposal_generator.", "head.")) or name.endswith(
                    ("cls_score", "sem_seg_head.predictor")):
                # RPN, classifiers: normal(0.01)
                w.copy_(torch.randn(w.shape, generator=g) * 0.01)
            elif name.endswith(("bbox_pred", "mask_head.predictor")):
                w.copy_(torch.randn(w.shape, generator=g) * 0.001)
            elif ".fpn_" in name or ".top_block." in name or isinstance(mod, Linear):
                # glorot / fan_avg uniform
                lim = math.sqrt(6.0 / (fan_in + fan_out))
                w.copy_((torch.rand(w.shape, generator=g) * 2 - 1) * lim)
            else:
                # variance_scaling(2.0, "fan_out", "normal")
                w.copy_(torch.randn(w.shape, generator=g)
                        * math.sqrt(2.0 / fan_out))
            if mod.bias is not None:
                mod.bias.zero_()
    return model
