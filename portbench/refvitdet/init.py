"""The port's seeded init (``weights.seeded_init``) for the modules of ViTDet
Cascade Mask R-CNN: every weight drawn, in module order, from a CPU
generator seeded with ``seed`` (biases zero, norms identity), by the JAX
package's initializer for its kind of layer, and then, in parameter order,
``pos_embed`` and every relative-position table from normal(0.02).

The tables depart from detectron2, which starts them at zero (under MAE
weights that hold none): at seeded weights a zero table gives a zero bias,
which no comparison could see.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from portbench.refmodel.init import _fans

TABLES = ("pos_embed", "rel_pos_h", "rel_pos_w")


def _lecun(w: torch.Tensor, fan_in: int, g: torch.Generator) -> torch.Tensor:
    """flax's lecun normal: variance_scaling(1.0, "fan_in", "truncated_normal")."""
    return (torch.nn.init.trunc_normal_(torch.empty(w.shape), std=1.0, a=-2.0, b=2.0,
                                        generator=g)
            * math.sqrt(1.0 / fan_in) / 0.87962566103423978)


def seeded_init(model: nn.Module, seed: int = 0) -> nn.Module:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.fill_(0.0)
                continue
            if not isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                continue
            w = mod.weight
            transposed = isinstance(mod, nn.ConvTranspose2d)
            fan_in, fan_out = _fans(w, transposed)
            trunk = name.startswith("backbone.net.") and (
                isinstance(mod, nn.Linear) or name.endswith("patch_embed.proj"))
            if trunk or (transposed and name.startswith("backbone.simfp_")):
                w.copy_(_lecun(w, fan_in, g))
            elif name.startswith("proposal_generator.") or name.endswith("cls_score"):
                w.copy_(torch.randn(w.shape, generator=g) * 0.01)
            elif name.endswith(("bbox_pred", "mask_head.predictor")):
                w.copy_(torch.randn(w.shape, generator=g) * 0.001)
            elif ".simfp_" in name or isinstance(mod, nn.Linear):
                # glorot / fan_avg uniform
                lim = math.sqrt(6.0 / (fan_in + fan_out))
                w.copy_((torch.rand(w.shape, generator=g) * 2 - 1) * lim)
            else:
                # variance_scaling(2.0, "fan_out", "normal")
                w.copy_(torch.randn(w.shape, generator=g) * math.sqrt(2.0 / fan_out))
            if mod.bias is not None:
                mod.bias.zero_()
        for name, p in model.named_parameters():
            if name.endswith(TABLES):
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    return model
