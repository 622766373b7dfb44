"""PanopticFPN's training forward: GeneralizedRCNN's losses and the
sem-seg head's. Raw RGB ``(B, H, W, 3)`` images with ``gt``,
``sem_seg_gt`` and ``train=True`` on a model in training mode give the dict
of losses, differentiable w.r.t. the parameters."""
from __future__ import annotations

from typing import Optional

import torch

from portbench.refmodel.config import ModelConfig
from portbench.refmodel.rcnn import GeneralizedRCNN, check_mode
from portbench.refmodel.sem_seg import SemSegFPNHead
from portbench.refmodel.instances import GtInstances


class PanopticFPN(GeneralizedRCNN):
    """GeneralizedRCNN + the sem-seg head and the panoptic fusion."""

    def __init__(self, cfg: ModelConfig, input_hw=None):
        super().__init__(cfg, input_hw)
        self.sem_seg_head = SemSegFPNHead(cfg.sem_seg_head, cfg.fpn.out_channels)

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor,
                gt: Optional[GtInstances] = None,
                sem_seg_gt: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None,
                proposals=None):
        """The loss dict; fg/bg sampling draws from ``generator``. With
        ``proposals`` (boxes, scores, valid) the ROI heads take those in
        place of the RPN's own (whose losses are computed all the same)."""
        check_mode(self, train)
        if not train:
            raise ValueError("the reference's Panoptic FPN only trains")
        return self.losses_from_features(self.features(images), image_sizes, gt,
                                         sem_seg_gt, generator, proposals)

    def losses_from_features(self, features, image_sizes, gt: GtInstances,
                             sem_seg_gt, generator=None, proposals=None):
        """The train forward after the backbone: features {"p2".."p6"} (NCHW,
        channels-last memory) -> the loss dict."""
        out = {}
        if sem_seg_gt is not None:
            out.update(self.sem_seg_head.losses(self.sem_seg_head(features),
                                                sem_seg_gt))
        out.update(super().losses_from_features(features, image_sizes, gt,
                                                generator, proposals))
        return out
