"""Weights: the port's seeded init and the bridge from the JAX package's trees.

``seeded_init`` draws every parameter from a seeded ``torch.Generator`` with
the JAX package's initializer for that layer (biases zero, norms identity).

``from_jax(params, batch_stats)`` takes the JAX package's variable trees as
nested dicts of arrays and returns the port's ``state_dict`` (detectron2
names), for any of the six meta-architectures over any backbone (ResNet,
ViTDet, the RegNet, Swin and MViT trunks under the FPN). For PanopticFPN it inverts
``convert_d2_panoptic_fpn`` of the JAX package's checkpoint module. The
layout changes:

- the box head's ``fc1`` rows: the JAX heads flatten their (R, S, S, C)
  input in NHWC order, the port (like d2) in NCHW order;
- the transposed-conv kernels (the mask head's ``deconv``, the keypoint
  head's ``score_lowres``): flax applies them unflipped, torch flips them,
  so the spatial axes are reversed;
- the norms: flax names them ``BatchNorm_{i}`` (``FrozenBatchNorm_{i}``,
  ``GroupNorm_{i}``) in build order: in the FPN lateral then output for
  res5 down to res2, in a box head per conv, in a dense head the class
  tower's then the box tower's;
- the dense heads' towers are detectron2 Sequentials: a conv at every
  second slot, or every third with a norm between conv and relu;
- the trunks: Dense kernels transposed, LayerNorm ``scale`` -> ``weight``,
  ViT's ``pos_embed`` kept as it is ((1, gh, gw, dim), NHWC: its shape is
  the grid the model was built for), Swin's ``rel_pos_bias`` ->
  ``relative_position_bias_table``, ViTDet's pyramid transposed convs
  flipped as above; a RegNet block's norms numbered a, b, c, proj; MViT's
  ``s{stage}_b{i}`` numbered across stages.

``projects_from_jax(module, params, batch_stats, constants)`` maps the JAX
trees of the project modules (``ASPP``, ``DepthwiseSeparableConv``, the
DeepLab and Panoptic-DeepLab heads, ``DeformConv`` / ``ModulatedDeformConv``,
``BatchNormBatchStats``, PointRend's ``PointHead``, the TridentNet blocks,
``TensorMask``, the DensePose chart and CSE heads and the vertex embedders)
onto the port module's own names, which are the JAX package's (``b0`` ...
``b3``, ``pool_conv``, ``project``, ``aspp``, ``dec1``, ``fc0``,
``trident``, ``body_conv_fcn1``, ``embedder_{mesh}``, ...): convs
transposed, a deformable or trident ``kernel`` to ``weight``, Dense kernels
transposed, transposed-conv kernels flipped, a module's ``norms.{i}`` from
flax's ``{BatchNorm,GroupNorm,...}_{i}``, and any other parameter by its own
name (a buffer from the ``constants`` collection).

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


# the transformer trunks (ViT, Swin, MViT) and ViTDet's pyramid: flax's
# default initializer (lecun normal) for their Dense, patch and transposed
# convs, normal(0.02) for ``pos_embed`` and the relative position tables
# (ViTDet's decomposed ones too: detectron2 starts them at zero under MAE
# weights that hold none, which on seeded weights would leave the bias at
# zero)
_TRANSFORMER_TRUNKS = ("backbone.net.", "backbone.bottom_up.")
_TABLES = ("pos_embed", "relative_position_bias_table", "rel_pos_h", "rel_pos_w")


def _lecun(name: str, mod: nn.Module) -> bool:
    if isinstance(mod, nn.ConvTranspose2d):
        return name.startswith("backbone.simfp_")
    return name.startswith(_TRANSFORMER_TRUNKS) and (
        type(mod) is nn.Linear or name.endswith("patch_embed.proj"))


def seeded_init(model: nn.Module, seed: int = 0) -> nn.Module:
    """Draw every weight with the JAX package's initializer, from a CPU
    generator seeded with ``seed`` (same numbers on any machine)."""
    from u2seg_torch.models.dense_detector import DenseHead
    from u2seg_torch.ops import deform_conv

    from u2seg_torch.projects import densepose_cse, tensormask, tridentnet

    g = torch.Generator().manual_seed(seed)
    # the project modules take flax's default conv init (lecun normal),
    # TensorMask's head normal(0.01) everywhere
    flax_default = tuple(name + "." if name else "" for name, mod in model.named_modules()
                         if isinstance(mod, _project_types()))
    normal_001 = tuple(name + "." if name else "" for name, mod in model.named_modules()
                       if isinstance(mod, tensormask.TensorMaskHead))
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (deform_conv.DeformConv, deform_conv.ModulatedDeformConv)):
                deform_conv.reset_deform_parameters(mod, g)
            if isinstance(mod, (densepose_cse.VertexDirectEmbedder,
                                densepose_cse.VertexFeatureEmbedder)):
                for p in mod.parameters(recurse=False):       # normal(0.01)
                    p.copy_(torch.randn(p.shape, generator=g) * 0.01)
                continue
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
            if name.endswith(("offset_conv", "offset_mask_conv")):
                continue                               # zero, set with their module
            if isinstance(mod, tridentnet.TridentConv):
                # variance_scaling(2.0, "fan_out", "normal")
                w.copy_(torch.randn(w.shape, generator=g) * math.sqrt(2.0 / fan_out))
            elif normal_001 and name.startswith(normal_001):
                w.copy_(torch.randn(w.shape, generator=g) * 0.01)
            elif _lecun(name, mod) or (flax_default and name.startswith(flax_default)):
                # variance_scaling(1.0, "fan_in", "truncated_normal")
                w.copy_(torch.nn.init.trunc_normal_(torch.empty(w.shape), std=1.0,
                                                    a=-2.0, b=2.0, generator=g)
                        * math.sqrt(1.0 / fan_in) / 0.87962566103423978)
            elif name.startswith(("proposal_generator.", "head.")) or name.endswith(
                    ("cls_score", "sem_seg_head.predictor")):
                # RPN, dense heads, classifiers: normal(0.01)
                w.copy_(torch.randn(w.shape, generator=g) * 0.01)
            elif name.endswith(("bbox_pred", "mask_head.predictor")):
                w.copy_(torch.randn(w.shape, generator=g) * 0.001)
            elif (".fpn_" in name or ".top_block." in name or ".simfp_" in name
                  or isinstance(mod, Linear)):
                # glorot / fan_avg uniform
                lim = math.sqrt(6.0 / (fan_in + fan_out))
                w.copy_((torch.rand(w.shape, generator=g) * 2 - 1) * lim)
            else:
                # variance_scaling(2.0, "fan_out", "normal")
                w.copy_(torch.randn(w.shape, generator=g)
                        * math.sqrt(2.0 / fan_out))
            if mod.bias is not None:
                mod.bias.zero_()
        for name, p in model.named_parameters():
            if name.endswith(_TABLES):
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
        for mod in model.modules():
            if isinstance(mod, (DenseHead, tensormask.TensorMaskHead)):
                # the classifier starts at the prior probability
                p = mod.prior_prob
                mod.cls_score.bias.fill_(-math.log((1 - p) / p))
    return model


# ---------------------------------------------------------------------------
# JAX trees -> port state dict
# ---------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    return np.array(x, dtype=np.float32)   # a writable copy


# convert_d2_panoptic_fpn reorders fc1 rows for a 7 x 7 pooled input
_FC1_RESOLUTION = 7
_NORM_KINDS = ("BatchNorm", "FrozenBatchNorm", "GroupNorm", "BatchNormBatchStats")


def _transformer_block(blk, dst, ln, fc, attn=("qkv", "proj")):
    """norm1, attention Dense layers, norm2, mlp_fc1/2 of a flax block ->
    ``dst.{norm1,attn.*,norm2,mlp.fc1,mlp.fc2}``."""
    ln(dst + ".norm1", blk["norm1"])
    ln(dst + ".norm2", blk["norm2"])
    for name in attn:
        fc(f"{dst}.attn.{name}", blk["attn"][name])
    fc(dst + ".mlp.fc1", blk["mlp_fc1"])
    fc(dst + ".mlp.fc2", blk["mlp_fc2"])



def from_jax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """JAX variable trees of any of the six meta-architectures -> the port's
    ``state_dict`` (CPU f32 tensors)."""
    sd: Dict[str, np.ndarray] = {}

    def conv(dst, tree):
        sd[dst + ".weight"] = _np(tree["kernel"]).transpose(3, 2, 0, 1)
        if "bias" in tree:
            sd[dst + ".bias"] = _np(tree["bias"])

    def deconv(dst, tree):
        # flax applies the kernel unflipped, torch's transposed conv flipped
        sd[dst + ".weight"] = np.ascontiguousarray(
            _np(tree["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1))
        sd[dst + ".bias"] = _np(tree["bias"])

    def norm(dst, ptree, stree, i) -> bool:
        """The ``i``-th auto-named norm of a flax scope (BN, FrozenBN or GN)
        -> ``dst``; False when the scope has none."""
        for kind in _NORM_KINDS:
            key = f"{kind}_{i}"
            if key in ptree:
                sd[dst + ".weight"] = _np(ptree[key]["scale"])
                sd[dst + ".bias"] = _np(ptree[key]["bias"])
                if kind != "GroupNorm":
                    sd[dst + ".running_mean"] = _np(stree[key]["mean"])
                    sd[dst + ".running_var"] = _np(stree[key]["var"])
                return True
        return False

    def fc(dst, tree):
        sd[dst + ".weight"] = _np(tree["kernel"]).T
        sd[dst + ".bias"] = _np(tree["bias"])

    def scope(tree, *path):
        for k in path:
            tree = tree.get(k, {})
        return tree

    def ln(dst, tree):
        sd[dst + ".weight"] = _np(tree["scale"])
        sd[dst + ".bias"] = _np(tree["bias"])

    bb = params["backbone"]
    pre = "backbone.bottom_up"
    if "bottom_up" in bb:                 # ResNet
        bp = bb["bottom_up"]
        bs = scope(batch_stats, "backbone", "bottom_up")
        conv(f"{pre}.stem.conv1", bp["stem"]["conv1"])
        norm(f"{pre}.stem.conv1.norm", bp["stem"], bs.get("stem", {}), 0)
        for key, blk in bp.items():
            m = re.fullmatch(r"(res\d)_(\d+)", key)
            if not m:
                continue
            dst = f"{pre}.{m.group(1)}.{m.group(2)}"
            names = ["conv1", "conv2", "conv3"] + (["shortcut"] if "shortcut" in blk else [])
            for ci, cname in enumerate(names):
                conv(f"{dst}.{cname}", blk[cname])
                norm(f"{dst}.{cname}.norm", blk, bs.get(key, {}), ci)
    elif "vit" in bb:                     # ViTDet: ``vit`` + ``sfp``
        vp = bb["vit"]
        conv("backbone.net.patch_embed.proj", vp["patch_embed"])
        sd["backbone.net.pos_embed"] = _np(vp["pos_embed"])      # (1, gh, gw, dim)
        for key, blk in vp.items():
            if re.fullmatch(r"block\d+", key):
                _transformer_block(blk, f"backbone.net.blocks.{key[5:]}", ln, fc)
        sfp = bb["sfp"]
        for lvl, first in ((2, 4), (3, 1), (4, 0), (5, 1)):
            dst = f"backbone.simfp_{lvl}"
            if lvl == 2:
                deconv(f"{dst}.0", sfp["p2_up1"])
                ln(f"{dst}.1", sfp["p2_ln_up"])
                deconv(f"{dst}.3", sfp["p2_up2"])
            elif lvl == 3:
                deconv(f"{dst}.0", sfp["p3_up1"])
            for i, (cname, nname) in enumerate((("lateral", "ln1"), ("output", "ln2"))):
                conv(f"{dst}.{first + i}", sfp[f"p{lvl}_{cname}"])
                ln(f"{dst}.{first + i}.norm", sfp[f"p{lvl}_{nname}"])
    elif "stem" in bb["trunk"]:           # RegNet: a block's norms a, b, c, proj
        tp = bb["trunk"]
        ts = scope(batch_stats, "backbone", "trunk")
        conv(f"{pre}.stem", tp["stem"])
        norm(f"{pre}.stem.norm", tp, ts, 0)
        for key, blk in tp.items():
            m = re.fullmatch(r"s(\d+)_b(\d+)", key)
            if not m:
                continue
            dst = f"{pre}.s{m.group(1)}.{m.group(2)}"
            for ci, cname in enumerate(("a", "b", "c", "proj")):
                if cname in blk:
                    conv(f"{dst}.{cname}", blk[cname])
                    norm(f"{dst}.{cname}.norm", blk, ts.get(key, {}), ci)
    elif "patch_norm" in bb["trunk"]:     # Swin
        tp = bb["trunk"]
        conv(f"{pre}.patch_embed.proj", tp["patch_embed"])
        ln(f"{pre}.patch_embed.norm", tp["patch_norm"])
        for key, blk in tp.items():
            m = re.fullmatch(r"stage(\d+)_block(\d+)", key)
            if m:
                dst = f"{pre}.layers.{m.group(1)}.blocks.{m.group(2)}"
                _transformer_block(blk, dst, ln, fc)
                sd[dst + ".attn.relative_position_bias_table"] = _np(
                    blk["attn"]["rel_pos_bias"])
            elif re.fullmatch(r"merge\d+", key):
                dst = f"{pre}.layers.{key[5:]}.downsample"
                ln(dst + ".norm", blk["norm"])
                sd[dst + ".reduction.weight"] = _np(blk["reduction"]["kernel"]).T
            elif re.fullmatch(r"res\d_out_norm", key):
                ln(f"{pre}.norm{int(key[3]) - 2}", blk)
    else:                                 # MViT: blocks numbered across stages
        tp = bb["trunk"]
        conv(f"{pre}.patch_embed.proj", tp["patch_embed"])
        keys = sorted((k for k in tp if re.fullmatch(r"s\d+_b\d+", k)),
                      key=lambda k: tuple(int(v) for v in re.findall(r"\d+", k)))
        for n, key in enumerate(keys):
            blk, dst = tp[key], f"{pre}.blocks.{n}"
            _transformer_block(blk, dst, ln, fc, attn=("q", "k", "v", "proj"))
            if "shortcut_proj" in blk:
                fc(dst + ".shortcut_proj", blk["shortcut_proj"])
        for key, tree in tp.items():
            if re.fullmatch(r"res\d_norm", key):
                ln(f"{pre}.{key}", tree)

    # backbone FPN: norms numbered in build order (res5 lateral, output, ...);
    # p6 / p7 of the RetinaNet top block
    fp = bb.get("fpn", {})
    fs = scope(batch_stats, "backbone", "fpn")
    n_idx = 0
    for stage in ("res5", "res4", "res3", "res2"):
        if f"lateral_{stage}" not in fp:
            continue
        lvl = stage[-1]
        for kind, dst in (("lateral", f"backbone.fpn_lateral{lvl}"),
                          ("output", f"backbone.fpn_output{lvl}")):
            conv(dst, fp[f"{kind}_{stage}"])
            if norm(dst + ".norm", fp, fs, n_idx):
                n_idx += 1
    for p in ("p6", "p7"):
        if p in fp:
            conv(f"backbone.top_block.{p}", fp[p])

    # RPN head
    if "proposal_generator" in params:
        head = params["proposal_generator"]["head"]
        conv("proposal_generator.rpn_head.conv", head["conv0"])
        conv("proposal_generator.rpn_head.objectness_logits", head["objectness_logits"])
        conv("proposal_generator.rpn_head.anchor_deltas", head["anchor_deltas"])

    # ROI heads: box heads / predictors (cascade: box_head{k}; standard:
    # box_head), convs with their norms, then FCs
    rh = params.get("roi_heads", {})
    rs = batch_stats.get("roi_heads", {})
    for key, tree in rh.items():
        m = re.fullmatch(r"box_(head|predictor)(\d*)", key)
        if not m:
            continue
        dst = f"roi_heads.box_{m.group(1)}" + (f".{m.group(2)}" if m.group(2) else "")
        convs = sorted((k for k in tree if re.fullmatch(r"conv\d+", k)),
                       key=lambda k: int(k[4:]))
        for i, name in enumerate(convs):
            conv(f"{dst}.{name}", tree[name])
            norm(f"{dst}.{name}.norm", tree, rs.get(key, {}), i)
        for name, sub in tree.items():
            if re.fullmatch(r"fc\d+|cls_score|bbox_pred", name):
                fc(f"{dst}.{name}", sub)
        if m.group(1) == "head" and "fc1" in tree:
            # NHWC flatten (JAX) -> NCHW flatten (port, d2)
            w = sd[f"{dst}.fc1.weight"]
            o, i = w.shape
            c = tree[convs[-1]]["kernel"].shape[-1] if convs else i // _FC1_RESOLUTION ** 2
            s = math.isqrt(i // c)
            sd[f"{dst}.fc1.weight"] = (w.reshape(o, s, s, c)
                                       .transpose(0, 3, 1, 2).reshape(o, i))

    # mask head (the JAX head has no norm parameters: it never applies one)
    if "mask_head" in rh:
        mh = rh["mask_head"]
        for key, sub in mh.items():
            if key.startswith("mask_fcn") or key == "predictor":
                conv(f"roi_heads.mask_head.{key}", sub)
        deconv("roi_heads.mask_head.deconv", mh["deconv"])

    # keypoint head
    if "keypoint_head" in rh:
        kh = rh["keypoint_head"]
        for key, sub in kh.items():
            if key.startswith("conv_fcn"):
                conv(f"roi_heads.keypoint_head.{key}", sub)
        deconv("roi_heads.keypoint_head.score_lowres", kh["score_lowres"])

    # sem-seg head: {p}_conv{j} -> sem_seg_head.{p}.{2j}
    if "sem_seg_head" in params:
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

    # dense heads (RetinaNet, FCOS): {cls,box}_conv{i} -> head.{cls,bbox}_subnet,
    # one Sequential slot per conv, norm (numbered cls tower first) and relu
    if "head" in params:
        hp = params["head"]["head"]
        hs = scope(batch_stats, "head", "head")
        depth = sum(1 for k in hp if k.startswith("cls_conv"))
        step = 3 if any(f"{k}_0" in hp for k in _NORM_KINDS) else 2
        for t, (src, dst) in enumerate((("cls", "cls_subnet"), ("box", "bbox_subnet"))):
            for i in range(depth):
                conv(f"head.{dst}.{step * i}", hp[f"{src}_conv{i}"])
                norm(f"head.{dst}.{step * i + 1}", hp, hs, t * depth + i)
        conv("head.cls_score", hp["cls_score"])
        conv("head.bbox_pred", hp["bbox_pred"])
        if "centerness" in hp:
            conv("head.ctrness", hp["centerness"])

    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _project_types():
    from u2seg_torch.ops.aspp import ASPP, DepthwiseSeparableConv
    from u2seg_torch.projects.deeplab import DeepLabV3Head, DeepLabV3PlusHead
    from u2seg_torch.projects.densepose import DensePoseChartPredictor, DensePoseV1ConvXHead
    from u2seg_torch.projects.densepose_cse import DensePoseEmbeddingPredictor
    from u2seg_torch.projects.panoptic_deeplab import PanopticDeepLabHead
    from u2seg_torch.projects.pointrend import PointHead
    from u2seg_torch.projects.tridentnet import TridentBlock

    return (ASPP, DepthwiseSeparableConv, DeepLabV3Head, DeepLabV3PlusHead,
            PanopticDeepLabHead, PointHead, TridentBlock, DensePoseV1ConvXHead,
            DensePoseChartPredictor, DensePoseEmbeddingPredictor)


def projects_from_jax(module: nn.Module, params: Mapping, batch_stats: Mapping = None,
                      constants: Mapping = None) -> Dict[str, torch.Tensor]:
    """The JAX variable trees of a project module (see the module doc) ->
    ``module``'s state dict (CPU f32 tensors). ``params`` / ``batch_stats``
    / ``constants`` are the module's own scopes."""
    from u2seg_torch.ops.deform_conv import DeformConv, ModulatedDeformConv
    from u2seg_torch.projects.rethinking_bn import BatchNormBatchStats

    sd: Dict[str, np.ndarray] = {}

    def flax_norm(mod) -> str:
        if isinstance(mod, BatchNormBatchStats):
            return "BatchNormBatchStats"
        return "GroupNorm" if isinstance(mod, GroupNorm) else "BatchNorm"

    def norm(dst, mod, ptree, stree):
        sd[dst + "weight"] = _np(ptree["scale"])
        sd[dst + "bias"] = _np(ptree["bias"])
        if isinstance(mod, BatchNorm2d):
            sd[dst + "running_mean"] = _np(stree["mean"])
            sd[dst + "running_var"] = _np(stree["var"])

    def walk(mod, dst, ptree, stree, ctree):
        if isinstance(mod, BatchNorm2d) and not list(mod.children()):
            norm(dst, mod, ptree, stree)
            return
        deform = isinstance(mod, (DeformConv, ModulatedDeformConv))
        if deform:
            sd[dst + "weight"] = _np(ptree["kernel"]).transpose(3, 2, 0, 1)
            if isinstance(mod, ModulatedDeformConv):
                sd[dst + "bias"] = _np(ptree["bias"])
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            k = _np(ptree["kernel"])
            if isinstance(mod, nn.ConvTranspose2d):
                k = k[::-1, ::-1].transpose(2, 3, 0, 1)   # flax unflipped, torch flipped
            elif isinstance(mod, nn.Linear):
                k = k.T
            else:
                k = k.transpose(3, 2, 0, 1)
            sd[dst + "weight"] = k
            if mod.bias is not None:
                sd[dst + "bias"] = _np(ptree["bias"])
            return
        for name, _ in [] if deform else mod.named_parameters(recurse=False):
            sd[dst + name] = _np(ptree[name])
        for name, _ in [] if deform else mod.named_buffers(recurse=False):
            sd[dst + name] = _np(ctree[name])
        for name, child in mod.named_children():
            if name == "norms":
                for i, nm in enumerate(child):
                    key = f"{flax_norm(nm)}_{i}"
                    norm(f"{dst}norms.{i}.", nm, ptree[key], stree.get(key, {}))
                continue
            walk(child, f"{dst}{name}.", ptree.get(name, {}), stree.get(name, {}),
                 ctree.get(name, {}))

    walk(module, "", params, batch_stats or {}, constants or {})
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
