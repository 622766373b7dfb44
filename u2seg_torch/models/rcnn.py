"""GeneralizedRCNN, ProposalNetwork and SemanticSegmentor (counterpart of
``u2seg_tpu/models/rcnn.py``).

``GeneralizedRCNN`` is Faster, Mask, Cascade and Keypoint R-CNN by config:
backbone -> RPN -> Standard or Cascade ROI heads. ``ProposalNetwork`` stops
after the RPN and returns its proposals as class-0 detections;
``SemanticSegmentor`` is the backbone and the sem-seg head. Each takes raw
RGB ``(B, H, W, 3)`` images and ``image_sizes``; ``forward(..., train=True)``
on a model in training mode returns the loss dict, otherwise the outputs,
computed without autograd. Sampling draws from ``generator``.

The two small meta-architectures compute in f32 whatever
``compute_dtype`` says: the JAX package builds their backbone and heads with
no dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from u2seg_torch.config import ModelConfig
from u2seg_torch.models.backbone import build_backbone
from u2seg_torch.models.roi_heads import CascadeROIHeads, StandardROIHeads
from u2seg_torch.models.rpn import RPN
from u2seg_torch.models.sem_seg import SemSegFPNHead
from u2seg_torch.ops.consts import device_table
from u2seg_torch.structures.instances import Detections, GtInstances

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_mode(model: nn.Module, train: bool) -> None:
    if train != model.training:
        raise ValueError(
            f"forward(train={train}) on a model whose training mode is "
            f"{model.training}: call model.train() / model.eval() first")


class ImageModel(nn.Module):
    """What every meta-architecture shares: pixel normalization into the
    compute dtype, and the backbone's maps in channels-last memory (the
    pooler reads NHWC views of them)."""

    compute_dtype = torch.float32

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) raw RGB -> normalized NCHW (channels-last memory) in
        the compute dtype."""
        mean = device_table(self.cfg.pixel_mean, images.dtype, images.device)
        std = device_table(self.cfg.pixel_std, images.dtype, images.device)
        x = ((images - mean) / std).to(self.compute_dtype)
        return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    def features(self, images: torch.Tensor):
        feats = self.backbone(self.normalize(images))
        return {k: v.contiguous(memory_format=torch.channels_last)
                for k, v in feats.items()}


class GeneralizedRCNN(ImageModel):
    def __init__(self, cfg: ModelConfig, input_hw=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = torch_dtype(cfg.compute_dtype)
        ch = cfg.fpn.out_channels
        self.backbone = build_backbone(cfg, input_hw)
        self.proposal_generator = RPN(cfg.rpn, cfg.anchors, ch, self.compute_dtype)
        heads = (CascadeROIHeads if cfg.roi_heads.name == "CascadeROIHeads"
                 else StandardROIHeads)
        self.roi_heads = heads(cfg.roi_heads, ch, self.compute_dtype)

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor,
                gt: Optional[GtInstances] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        check_mode(self, train)
        if train:
            return self.losses_from_features(self.features(images), image_sizes,
                                             gt, generator)
        with torch.no_grad():
            features = self.features(images)
            rpn = self.proposal_generator(features, image_sizes)
            return self.roi_heads(features, rpn.proposal_boxes,
                                  rpn.proposal_scores, rpn.proposal_valid,
                                  image_sizes)

    def losses_from_features(self, features, image_sizes, gt: GtInstances,
                             generator=None):
        rpn = self.proposal_generator(features, image_sizes, gt=gt, train=True,
                                      generator=generator)
        out = dict(rpn.losses)
        out.update(self.roi_heads(
            features, rpn.proposal_boxes, rpn.proposal_scores,
            rpn.proposal_valid, image_sizes, gt=gt, train=True,
            generator=generator))
        return out


class ProposalNetwork(ImageModel):
    """Backbone + RPN; the proposals come out as ``Detections`` of class 0
    with the objectness logits as scores (-inf on empty slots)."""

    def __init__(self, cfg: ModelConfig, input_hw=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = build_backbone(cfg, input_hw)
        self.proposal_generator = RPN(cfg.rpn, cfg.anchors, cfg.fpn.out_channels)

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor,
                gt: Optional[GtInstances] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        check_mode(self, train)
        with torch.set_grad_enabled(train):
            out = self.proposal_generator(self.features(images), image_sizes,
                                          gt=gt, train=train, generator=generator)
        if train:
            return out.losses
        return Detections(
            boxes=out.proposal_boxes, scores=out.proposal_scores,
            classes=torch.zeros(out.proposal_scores.shape, dtype=torch.int32,
                                device=images.device),
            valid=out.proposal_valid)


class SemanticSegmentor(ImageModel):
    """Backbone + sem-seg head: stride-4 logits (B, H/4, W/4, C) f32, or with
    ``sem_seg_gt`` (B, H, W) and ``train`` the ``loss_sem_seg`` dict."""

    def __init__(self, cfg: ModelConfig, input_hw=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = build_backbone(cfg, input_hw)
        self.sem_seg_head = SemSegFPNHead(cfg.sem_seg_head, cfg.fpn.out_channels)

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor,
                sem_seg_gt: Optional[torch.Tensor] = None, train: bool = False):
        check_mode(self, train)
        with torch.set_grad_enabled(train):
            logits = self.sem_seg_head(self.features(images))
        if train:
            return self.sem_seg_head.losses(logits, sem_seg_gt)
        return logits
