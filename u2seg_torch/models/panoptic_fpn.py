"""PanopticFPN meta-architecture + panoptic fusion (counterpart of
``u2seg_tpu/models/panoptic_fpn.py``).

``PanopticFPN.forward(images, image_sizes, combine=...)`` is the JAX
package's ``__call__(..., train=False, combine=...)``: raw RGB ``(B, H, W,
3)`` in, a ``PanopticOutput`` with fixed-capacity detections, stride-4
semantic logits and, with ``combine``, the stride-4 panoptic id map and
segment table out; it runs without autograd. With ``gt``, ``sem_seg_gt`` and
``train=True`` on a model in training mode (``model.train()``) it returns the
dict of losses, differentiable w.r.t. the parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from u2seg_torch.config import ModelConfig
from u2seg_torch.models.rcnn import GeneralizedRCNN, check_mode
from u2seg_torch.models.sem_seg import SemSegFPNHead
from u2seg_torch.ops.fusion import greedy_take, winner_map
from u2seg_torch.ops.mask_paste import paste_masks
from u2seg_torch.structures.instances import Detections, GtInstances


@dataclasses.dataclass
class PanopticOutput:
    detections: Detections           # boxes/scores/classes/valid/mask_logits
    sem_seg_logits: torch.Tensor     # (B, H/4, W/4, C_stuff) f32
    panoptic: Optional[torch.Tensor] = None          # (B, H/4, W/4) int32
    seg_category: Optional[torch.Tensor] = None      # (B, S) int32
    seg_is_thing: Optional[torch.Tensor] = None      # (B, S) bool
    seg_score: Optional[torch.Tensor] = None         # (B, S) f32
    seg_valid: Optional[torch.Tensor] = None         # (B, S) bool
    seg_instance_idx: Optional[torch.Tensor] = None  # (B, S) int32


class PanopticFPN(GeneralizedRCNN):
    """GeneralizedRCNN + the sem-seg head and the panoptic fusion."""

    def __init__(self, cfg: ModelConfig, input_hw=None):
        super().__init__(cfg, input_hw)
        self.sem_seg_head = SemSegFPNHead(cfg.sem_seg_head, cfg.fpn.out_channels)

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor,
                gt: Optional[GtInstances] = None,
                sem_seg_gt: Optional[torch.Tensor] = None,
                train: bool = False, combine: bool = False,
                generator: Optional[torch.Generator] = None):
        check_mode(self, train)
        if train:
            return self.losses(images, image_sizes, gt, sem_seg_gt, generator)
        with torch.no_grad():
            return self.inference(images, image_sizes, combine)

    def losses(self, images, image_sizes, gt: GtInstances, sem_seg_gt,
               generator=None):
        """The train forward -> {loss name: scalar}; fg/bg sampling draws
        from ``generator``."""
        return self.losses_from_features(self.features(images), image_sizes, gt,
                                         sem_seg_gt, generator)

    def losses_from_features(self, features, image_sizes, gt: GtInstances,
                             sem_seg_gt, generator=None):
        """The train forward after the backbone: features {"p2".."p6"} (NCHW,
        channels-last memory) -> the loss dict."""
        out = {}
        if sem_seg_gt is not None:
            out.update(self.sem_seg_head.losses(self.sem_seg_head(features),
                                                sem_seg_gt))
        out.update(super().losses_from_features(features, image_sizes, gt,
                                                generator=generator))
        return out

    def inference(self, images: torch.Tensor, image_sizes: torch.Tensor,
                  combine: bool = False) -> PanopticOutput:
        features = self.features(images)
        sem_logits = self.sem_seg_head(features)
        rpn = self.proposal_generator(features, image_sizes)
        det = self.roi_heads(features, rpn.proposal_boxes,
                             rpn.proposal_scores, rpn.proposal_valid,
                             image_sizes)
        out = PanopticOutput(detections=det, sem_seg_logits=sem_logits)
        if combine:
            p = self.cfg.panoptic
            pan, cat, isth, score, valid, inst = combine_semantic_and_instance(
                det, sem_logits, image_sizes,
                instance_conf_thresh=p.instance_conf_thresh,
                overlap_thresh=p.overlap_thresh,
                stuff_area_limit=p.stuff_area_limit)
            out = dataclasses.replace(
                out, panoptic=pan, seg_category=cat, seg_is_thing=isth,
                seg_score=score, seg_valid=valid, seg_instance_idx=inst)
        return out


def combine_semantic_and_instance(
    det: Detections,
    sem_logits: torch.Tensor,
    image_sizes: torch.Tensor,
    instance_conf_thresh: float = 0.5,
    overlap_thresh: float = 0.5,
    stuff_area_limit: int = 4096,
    stride: int = 4,
):
    """Paint a stride-4 panoptic segment-id map per image.

    Instances in descending score order (stable); an instance is skipped if
    its score is below the threshold, its pasted mask is empty, or more than
    ``overlap_thresh`` of it is already claimed by a kept instance. The greedy
    pass is computed as the JAX package computes it: the fixpoint
    ``take <- F(take)`` from "every eligible instance", iterated until it
    stops changing (the registered op ``ops.fusion.greedy_take``). Stuff labels (> 0) fill unclaimed pixels when their
    full-resolution area reaches ``stuff_area_limit``.
    Segment ids: sorted instance slot i -> i+1, stuff label l -> K+1+l.

    Returns (panoptic (B,h,w), seg_category, seg_is_thing, seg_score,
    seg_valid, seg_instance_idx), each (B, K + num_stuff) after the map.
    """
    b, k = det.valid.shape
    h, w, num_stuff = sem_logits.shape[1:]
    dev = sem_logits.device
    sem_label = torch.argmax(sem_logits, dim=-1).to(torch.int32)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]

    outs = []
    for i in range(b):
        boxes, scores = det.boxes[i], det.scores[i]
        valid, classes = det.valid[i], det.classes[i]
        masked = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
        ordr = torch.sort(-masked, stable=True)[1]
        hw = image_sizes[i].to(torch.float32)
        inside = ((yy < torch.ceil(hw[0] / stride))
                  & (xx < torch.ceil(hw[1] / stride)))
        masks = paste_masks(torch.sigmoid(det.mask_logits[i][ordr]),
                            boxes[ordr] / stride, h, w) > 0.5
        masks = masks & inside
        area = masks.sum(dim=(1, 2))
        eligible = valid[ordr] & (scores[ordr] >= instance_conf_thresh) & (area > 0)

        take = greedy_take(masks, eligible, area, overlap_thresh)
        wm = winner_map(masks, take)
        claimed = wm < k
        inst_id_map = torch.where(claimed, wm + 1, 0)

        sem_lab = sem_label[i]
        stuff_mask = (~claimed) & (sem_lab > 0) & inside
        # a bincount of the stuff pixels, with a shape that does not depend
        # on the data (no boolean index): exportable
        areas = torch.zeros(num_stuff, dtype=torch.int64, device=dev).scatter_add_(
            0, sem_lab.reshape(-1).long(), stuff_mask.reshape(-1).long())
        stuff_ok = areas * (stride * stride) >= stuff_area_limit
        lab_ok = stuff_ok[sem_lab.long()] & stuff_mask
        stuff_id_map = torch.where(lab_ok, k + 1 + sem_lab, 0)
        pan = (inst_id_map + stuff_id_map).to(torch.int32)

        seg_cat = torch.cat([classes[ordr].to(torch.int32),
                             torch.arange(num_stuff, dtype=torch.int32, device=dev)])
        seg_isthing = torch.cat([torch.ones(k, dtype=torch.bool, device=dev),
                                 torch.zeros(num_stuff, dtype=torch.bool, device=dev)])
        seg_score = torch.cat([scores[ordr].float(),
                               torch.zeros(num_stuff, device=dev)])
        seg_valid = torch.cat([take, stuff_ok])
        seg_inst = torch.cat([ordr.to(torch.int32),
                              torch.full((num_stuff,), -1, dtype=torch.int32, device=dev)])
        outs.append((pan, seg_cat, seg_isthing, seg_score, seg_valid, seg_inst))
    return tuple(torch.stack(t) for t in zip(*outs))

