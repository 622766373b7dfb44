"""ViTDet Cascade Mask R-CNN's training forward: the ViTDet backbone
(``vit``), an RPN whose head stacks detectron2's ``conv_dims`` 3x3 convs
(``rpn_head.conv.conv0``, ``.conv1``, each with a relu), and cascade ROI
heads whose box heads (convs, then fcs) and mask head normalise their convs
with a channel LayerNorm. The proposal stage, the sampling, the pooler's
plain twin, the cascade's targets and the losses are
``portbench.refmodel``'s; the names are the port's, so the two sides'
leaves pair up by name.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from portbench.refmodel import roi_heads as ref_roi
from portbench.refmodel import rpn as ref_rpn
from portbench.refmodel.layers import Conv2d, ConvTranspose2d, Linear
from portbench.refmodel.rcnn import ImageModel, check_mode, torch_dtype
from portbench.refmodel.roi_align_ml import MultiLevelPooler
from portbench.refvitdet.vit import ViT, ViTDet, LayerNorm2d


def get_norm(norm: str, ch: int) -> Optional[nn.Module]:
    if not norm:
        return None
    if norm != "LN":
        raise ValueError(f"the ViTDet reference has no norm {norm!r}")
    return LayerNorm2d(ch, eps=1e-6)


class RPNHead(nn.Module):
    """3x3 convs (``conv_dims``, -1: the input's channels), each with a relu,
    then the objectness and anchor-delta 1x1 convs, in ``dtype``."""

    def __init__(self, ch: int, anchors: int, dtype, conv_dims):
        super().__init__()
        self.dtype = dtype
        if len(conv_dims) == 1:
            out = ch if conv_dims[0] == -1 else conv_dims[0]
            self.conv = Conv2d(ch, out, 3, padding=1, activation=F.relu)
            ch = out
        else:
            self.conv = nn.Sequential()
            for k, dim in enumerate(conv_dims):
                out = ch if dim == -1 else dim
                self.conv.add_module(f"conv{k}", Conv2d(ch, out, 3, padding=1,
                                                        activation=F.relu))
                ch = out
        self.objectness_logits = Conv2d(ch, anchors, 1)
        self.anchor_deltas = Conv2d(ch, anchors * 4, 1)

    def forward(self, features):
        logits, deltas = [], []
        for x in features:
            t = self.conv(x.to(self.dtype))
            logits.append(self.objectness_logits(t))
            deltas.append(self.anchor_deltas(t))
        return logits, deltas


class RPN(ref_rpn.RPN):
    def __init__(self, cfg, anchor_cfg, ch: int, dtype):
        super().__init__(cfg, anchor_cfg, ch, dtype)
        self.rpn_head = RPNHead(ch, len(anchor_cfg.aspect_ratios), dtype,
                                tuple(cfg.head_conv_dims))


class ConvFCHead(nn.Module):
    """3x3 convs (no bias under a norm; the norm; relu), the NCHW flatten,
    fcs each with a relu, on (R, S, S, C) input."""

    def __init__(self, ch: int, resolution: int, num_conv: int, num_fc: int,
                 fc_dim: int, conv_dim: int, norm: str):
        super().__init__()
        self.num_conv, self.num_fc = num_conv, num_fc
        for i in range(num_conv):
            self.add_module(f"conv{i + 1}", Conv2d(
                ch, conv_dim, 3, padding=1, bias=not norm, norm=get_norm(norm, conv_dim),
                activation=F.relu))
            ch = conv_dim
        dim = ch * resolution * resolution
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", Linear(dim, fc_dim))
            dim = fc_dim
        self.out_dim = dim

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(self.num_conv):
            x = getattr(self, f"conv{i + 1}")(x)
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class MaskHead(nn.Module):
    """Convs with their norm, a 2x deconv with a relu, and a 1x1 predictor
    of which only each ROI's class is computed: (N, S, S, C) -> f32 mask
    logits (N, 2S, 2S, 1)."""

    def __init__(self, ch: int, classes: int, num_conv: int, conv_dim: int, norm: str):
        super().__init__()
        self.num_conv = num_conv
        for i in range(num_conv):
            self.add_module(f"mask_fcn{i + 1}", Conv2d(
                ch, conv_dim, 3, padding=1, bias=not norm, norm=get_norm(norm, conv_dim),
                activation=F.relu))
            ch = conv_dim
        self.deconv = ConvTranspose2d(ch, conv_dim, 2, stride=2)
        self.predictor = Conv2d(conv_dim, classes, 1)

    def forward(self, x, class_idx=None):
        x = x.permute(0, 3, 1, 2)
        for i in range(self.num_conv):
            x = getattr(self, f"mask_fcn{i + 1}")(x)
        x = F.relu(self.deconv(x))
        w = self.predictor.weight[:, :, 0, 0].to(x.dtype)
        bias = self.predictor.bias.to(x.dtype)
        if class_idx is None or w.shape[0] == 1:
            return (torch.einsum("nchw,oc->nhwo", x, w) + bias).float()
        cls = class_idx.long()
        out = torch.einsum("nchw,nc->nhw", x, w[cls]) + bias[cls][:, None, None]
        return out[..., None].float()


class CascadeROIHeads(ref_roi.CascadeROIHeads):
    """``refmodel``'s cascade (sampling, three stages, the mask loss on the
    first stage's samples) with these box and mask heads."""

    def __init__(self, cfg, ch: int, dtype, mask_fg_capacity: int = 128):
        nn.Module.__init__(self)
        self.cfg, self.compute_dtype = cfg, dtype
        self.mask_fg_capacity = mask_fg_capacity
        self.pooler = MultiLevelPooler()
        self._build_box_branch(ch)
        m = cfg.mask_head
        self.mask_head = MaskHead(ch, 1 if m.cls_agnostic_mask else cfg.num_classes,
                                  m.num_conv, m.conv_dim, m.norm)

    def _new_box_head(self, ch):
        b = self.cfg.box_head
        return ConvFCHead(ch, b.pooler_resolution, b.num_conv, b.num_fc, b.fc_dim,
                          b.conv_dim, b.norm)


class ViTDetRCNN(ImageModel):
    """Backbone -> RPN -> cascade heads; ``forward(..., train=True)`` on a
    model in training mode gives the loss dict. With ``proposals`` (boxes,
    scores, valid) the ROI heads take those in place of the RPN's own, whose
    losses are computed all the same."""

    def __init__(self, cfg, input_hw):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = torch_dtype(cfg.compute_dtype)
        b = cfg.backbone
        if cfg.roi_heads.name != "CascadeROIHeads" or not cfg.mask_on:
            raise ValueError("the ViTDet reference is Cascade Mask R-CNN")
        grid = tuple(s // b.vit_patch_size for s in input_hw)
        dtype = self.compute_dtype if b.vit_in_compute_dtype else torch.float32
        vit = ViT(grid, b.vit_patch_size, b.vit_dim, b.vit_depth, b.vit_num_heads,
                  b.vit_window_size, tuple(b.vit_global_blocks), b.vit_use_rel_pos,
                  b.vit_drop_path_rate, dtype)
        ch = cfg.fpn.out_channels
        self.backbone = ViTDet(vit, ch)
        self.proposal_generator = RPN(cfg.rpn, cfg.anchors, ch, self.compute_dtype)
        self.roi_heads = CascadeROIHeads(cfg.roi_heads, ch, self.compute_dtype)

    def features(self, images, generator=None):
        feats = self.backbone(self.normalize(images), generator)
        return {k: v.contiguous(memory_format=torch.channels_last) for k, v in feats.items()}

    def forward(self, images, image_sizes, gt=None, train=False, generator=None,
                proposals=None, sem_seg_gt=None):
        check_mode(self, train)
        if not train:
            raise ValueError("the ViTDet reference only trains")
        features = self.features(images, generator)
        rpn = self.proposal_generator(features, image_sizes, gt=gt, train=True,
                                      generator=generator)
        out = dict(rpn.losses)
        boxes, scores, valid = proposals or (
            rpn.proposal_boxes, rpn.proposal_scores, rpn.proposal_valid)
        out.update(self.roi_heads(features, boxes, scores, valid, image_sizes, gt=gt,
                                  train=True, generator=generator))
        return out


def set_quantizer(model: nn.Module, quantize) -> None:
    """Give every layer that holds a tensor in the compute dtype the rounding
    ``quantize`` (None: none)."""
    from portbench.refvitdet import vit

    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear, vit.Attention, vit.Mlp,
                          vit.Block, LayerNorm2d)):
            m.quantize = quantize
