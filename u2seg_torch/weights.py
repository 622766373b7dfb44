"""Weights: the port's seeded init and the bridge from the JAX package's trees.

``seeded_init`` draws every parameter from a seeded ``torch.Generator`` with
the JAX package's initializer for that layer (biases zero, norms identity).

``from_jax(params, batch_stats)`` takes the JAX package's variable trees as
nested dicts of arrays and returns the port's ``state_dict`` (detectron2
names). It inverts ``convert_d2_panoptic_fpn`` of the JAX package's
checkpoint module, including its three layout changes:

- the box head's ``fc1`` rows: the JAX heads flatten pooled (R, 7, 7, C) in
  NHWC order, the port (like d2) in NCHW order;
- the mask deconv kernel: flax applies ``ConvTranspose`` unflipped, torch
  flips it, so the spatial axes are reversed;
- the FPN norms: flax names them ``BatchNorm_{i}`` in build order, which is
  lateral then output for res5, res4, res3, res2.

``dino_from_jax(params)`` does the same for the JAX ``DinoViT`` tree: it
inverts ``convert_dino_vit`` (the patch kernel (p, p, 3, D) -> (D, 3, p, p),
Dense kernels transposed, ``block{i}`` -> ``blocks.{i}``) and returns the
official DINO names.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from u2seg_torch.models.layers import Linear
from u2seg_torch.ops.norms import BatchNorm2d, GroupNorm


# ---------------------------------------------------------------------------
# Seeded init
# ---------------------------------------------------------------------------

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
    """Draw every weight with the JAX package's initializer, from a CPU
    generator seeded with ``seed`` (same numbers on any machine)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (BatchNorm2d, GroupNorm)):
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
            if name.startswith("proposal_generator.") or name.endswith(
                    ("cls_score", "sem_seg_head.predictor")):
                w.copy_(torch.randn(w.shape, generator=g) * 0.01)
            elif name.endswith(("bbox_pred", "mask_head.predictor")):
                w.copy_(torch.randn(w.shape, generator=g) * 0.001)
            elif ".fpn_" in name or isinstance(mod, Linear):
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


# ---------------------------------------------------------------------------
# JAX trees -> port state dict
# ---------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    return np.array(x, dtype=np.float32)   # a writable copy


# convert_d2_panoptic_fpn reorders fc1 rows for a 7 x 7 pooled input
_FC1_RESOLUTION = 7


def from_jax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """JAX variable trees -> the port's ``state_dict`` (CPU f32 tensors)."""
    sd: Dict[str, np.ndarray] = {}

    def conv(dst, tree):
        sd[dst + ".weight"] = _np(tree["kernel"]).transpose(3, 2, 0, 1)
        if "bias" in tree:
            sd[dst + ".bias"] = _np(tree["bias"])

    def bn(dst, ptree, stree):
        sd[dst + ".weight"] = _np(ptree["scale"])
        sd[dst + ".bias"] = _np(ptree["bias"])
        sd[dst + ".running_mean"] = _np(stree["mean"])
        sd[dst + ".running_var"] = _np(stree["var"])

    def fc(dst, tree):
        sd[dst + ".weight"] = _np(tree["kernel"]).T
        sd[dst + ".bias"] = _np(tree["bias"])

    # backbone.bottom_up
    bp = params["backbone"]["bottom_up"]
    bs = batch_stats.get("backbone", {}).get("bottom_up", {})
    pre = "backbone.bottom_up"
    conv(f"{pre}.stem.conv1", bp["stem"]["conv1"])
    if "BatchNorm_0" in bp["stem"]:
        bn(f"{pre}.stem.conv1.norm", bp["stem"]["BatchNorm_0"],
           bs["stem"]["BatchNorm_0"])
    for key, blk in bp.items():
        m = re.fullmatch(r"(res\d)_(\d+)", key)
        if not m:
            continue
        dst = f"{pre}.{m.group(1)}.{m.group(2)}"
        names = ["conv1", "conv2", "conv3"] + (["shortcut"] if "shortcut" in blk else [])
        for ci, cname in enumerate(names):
            conv(f"{dst}.{cname}", blk[cname])
            if f"BatchNorm_{ci}" in blk:
                bn(f"{dst}.{cname}.norm", blk[f"BatchNorm_{ci}"],
                   bs[key][f"BatchNorm_{ci}"])

    # backbone FPN: norms numbered in build order (res5 lateral, output, ...)
    fp = params["backbone"]["fpn"]
    fs = batch_stats.get("backbone", {}).get("fpn", {})
    bn_idx = 0
    for stage in ("res5", "res4", "res3", "res2"):
        if f"lateral_{stage}" not in fp:
            continue
        lvl = stage[-1]
        for kind, dst in (("lateral", f"backbone.fpn_lateral{lvl}"),
                          ("output", f"backbone.fpn_output{lvl}")):
            conv(dst, fp[f"{kind}_{stage}"])
            if f"BatchNorm_{bn_idx}" in fp:
                bn(dst + ".norm", fp[f"BatchNorm_{bn_idx}"],
                   fs[f"BatchNorm_{bn_idx}"])
                bn_idx += 1

    # RPN head
    head = params["proposal_generator"]["head"]
    conv("proposal_generator.rpn_head.conv", head["conv0"])
    conv("proposal_generator.rpn_head.objectness_logits", head["objectness_logits"])
    conv("proposal_generator.rpn_head.anchor_deltas", head["anchor_deltas"])

    # box heads / predictors (cascade: box_head{k}; standard: box_head)
    rh = params["roi_heads"]
    s = _FC1_RESOLUTION
    for key, tree in rh.items():
        m = re.fullmatch(r"box_(head|predictor)(\d*)", key)
        if not m:
            continue
        dst = f"roi_heads.box_{m.group(1)}" + (f".{m.group(2)}" if m.group(2) else "")
        for name, sub in tree.items():
            fc(f"{dst}.{name}", sub)
        if m.group(1) == "head" and "fc1" in tree:
            w = sd[f"{dst}.fc1.weight"]
            o, i = w.shape
            c = i // (s * s)
            sd[f"{dst}.fc1.weight"] = (w.reshape(o, s, s, c)
                                       .transpose(0, 3, 1, 2).reshape(o, i))

    # mask head
    if "mask_head" in rh:
        mh = rh["mask_head"]
        for key, sub in mh.items():
            if key.startswith("mask_fcn") or key == "predictor":
                conv(f"roi_heads.mask_head.{key}", sub)
        sd["roi_heads.mask_head.deconv.weight"] = np.ascontiguousarray(
            _np(mh["deconv"]["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1))
        sd["roi_heads.mask_head.deconv.bias"] = _np(mh["deconv"]["bias"])

    # sem-seg head: {p}_conv{j} -> sem_seg_head.{p}.{2j}
    sp = params["sem_seg_head"]
    for key, sub in sp.items():
        m = re.fullmatch(r"(p\d)_(conv|gn)(\d+)", key)
        if not m:
            continue
        dst = f"sem_seg_head.{m.group(1)}.{2 * int(m.group(3))}"
        if m.group(2) == "conv":
            conv(dst, sub)
        else:
            sd[dst + ".norm.weight"] = _np(sub["scale"])
            sd[dst + ".norm.bias"] = _np(sub["bias"])
    conv("sem_seg_head.predictor", sp["predictor"])

    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def dino_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``DinoViT`` parameter tree -> a state dict in the official DINO
    names (CPU f32 tensors), the inverse of ``convert_dino_vit``."""
    sd: Dict[str, np.ndarray] = {
        "patch_embed.proj.weight": _np(params["patch_embed"]["kernel"]).transpose(3, 2, 0, 1),
        "patch_embed.proj.bias": _np(params["patch_embed"]["bias"]),
        "cls_token": _np(params["cls_token"]),
        "pos_embed": _np(params["pos_embed"]),
        "norm.weight": _np(params["norm"]["scale"]),
        "norm.bias": _np(params["norm"]["bias"]),
    }
    for key, blk in params.items():
        m = re.fullmatch(r"block(\d+)", key)
        if not m:
            continue
        dst = f"blocks.{m.group(1)}."
        for norm in ("norm1", "norm2"):
            sd[dst + norm + ".weight"] = _np(blk[norm]["scale"])
            sd[dst + norm + ".bias"] = _np(blk[norm]["bias"])
        for path in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")):
            tree = blk[path[0]][path[1]]
            sd[dst + ".".join(path) + ".weight"] = _np(tree["kernel"]).T
            sd[dst + ".".join(path) + ".bias"] = _np(tree["bias"])
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
