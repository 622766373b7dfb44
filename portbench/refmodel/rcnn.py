"""GeneralizedRCNN: backbone -> RPN -> Standard or Cascade ROI heads; raw
RGB ``(B, H, W, 3)`` images and ``image_sizes`` in; ``forward(...,
train=True)`` on a model in training mode returns the loss dict, otherwise
the detections, computed without autograd. Sampling draws from
``generator``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from portbench.refmodel.config import ModelConfig
from portbench.refmodel.fpn import FPN
from portbench.refmodel.roi_heads import CascadeROIHeads, StandardROIHeads
from portbench.refmodel.rpn import RPN
from portbench.refmodel.consts import device_table
from portbench.refmodel.instances import GtInstances

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
        self.backbone = FPN(cfg.resnet, cfg.fpn)
        self.proposal_generator = RPN(cfg.rpn, cfg.anchors, ch, self.compute_dtype)
        heads = (CascadeROIHeads if cfg.roi_heads.name == "CascadeROIHeads"
                 else StandardROIHeads)
        self.roi_heads = heads(cfg.roi_heads, ch, self.compute_dtype)

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor,
                gt: Optional[GtInstances] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        check_mode(self, train)
        return self.losses_from_features(self.features(images), image_sizes,
                                         gt, generator)

    def losses_from_features(self, features, image_sizes, gt: GtInstances,
                             generator=None, proposals=None):
        rpn = self.proposal_generator(features, image_sizes, gt=gt, train=True,
                                      generator=generator)
        out = dict(rpn.losses)
        boxes, scores, valid = proposals or (
            rpn.proposal_boxes, rpn.proposal_scores, rpn.proposal_valid)
        out.update(self.roi_heads(features, boxes, scores, valid, image_sizes,
                                  gt=gt, train=True, generator=generator))
        return out
