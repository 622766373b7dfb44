"""Panoptic-DeepLab: box-free bottom-up panoptic segmentation (counterpart
of ``u2seg_tpu/projects/panoptic_deeplab.py``; detectron2's
``projects/Panoptic-DeepLab``).

A semantic branch and an instance branch (per-pixel centre heatmap and
offsets to the centre) over one decoder; pixels are grouped to their
nearest predicted centre and fused with the semantic argmax into a
panoptic map. Everything stays on the device: centre NMS is max-pool
equality, then top-K centres and an argmin over the K distances. Ties
resolve to the first index (the stable top-K, ``argmin``, ``argmax``), as in
the JAX package, so instance ids and panoptic maps are equal to its.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from u2seg_torch.models.layers import Conv2d
from u2seg_torch.ops.aspp import ASPP, DepthwiseSeparableConv, resize_bilinear
from u2seg_torch.ops.nms import topk_stable


class PanopticDeepLabHead(nn.Module):
    """A shared decoder (ASPP on res5, a 48-wide res2 skip, one separable
    conv) with the semantic predictor and the instance branch (one separable
    conv, then the centre and the offset predictors)."""

    def __init__(self, res5_channels: int, res2_channels: int, num_classes: int,
                 decoder_dim: int = 256, head_dim: int = 32, norm: str = "GN"):
        super().__init__()
        self.aspp = ASPP(res5_channels, decoder_dim, norm=norm)
        self.low_proj = Conv2d(res2_channels, 48, 1)
        self.dec = DepthwiseSeparableConv(decoder_dim + 48, decoder_dim, norm=norm)
        self.sem_predictor = Conv2d(decoder_dim, num_classes, 1)
        self.ins_dec = DepthwiseSeparableConv(decoder_dim, head_dim, norm=norm)
        self.center_predictor = Conv2d(head_dim, 1, 1)
        self.offset_predictor = Conv2d(head_dim, 2, 1)

    def forward(self, features: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> semantic logits (B, C, h, w), centre heatmap (B, h, w) and
        offsets (B, 2, h, w) (dy, dx), at res2's resolution."""
        x = self.aspp(features["res5"])
        low = self.low_proj(features["res2"])
        x = torch.cat([resize_bilinear(x, low.shape[2:]), low], dim=1)
        x = self.dec(x)
        ins = self.ins_dec(x)
        return (self.sem_predictor(x), self.center_predictor(ins)[:, 0],
                self.offset_predictor(ins))


def group_pixels_to_instances(center_heatmap: torch.Tensor, offsets: torch.Tensor,
                              thing_mask: torch.Tensor, max_centers: int = 128,
                              center_threshold: float = 0.1, nms_kernel: int = 7
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Instance ids of one image from its centre heatmap (H, W), offsets
    (2, H, W) (dy, dx toward the centre) and thing mask (H, W) bool ->
    (ids (H, W) int32, 0 = no instance; centre scores (max_centers,), -inf
    for no centre)."""
    h, w = center_heatmap.shape
    pad = nms_kernel // 2
    pooled = F.max_pool2d(center_heatmap[None, None], nms_kernel, 1, pad)[0, 0]
    is_peak = (center_heatmap >= pooled) & (center_heatmap > center_threshold)
    scores = torch.where(is_peak, center_heatmap,
                         torch.full_like(center_heatmap, -math.inf)).reshape(-1)
    top_scores, top_idx = topk_stable(scores, max_centers)
    cy = torch.div(top_idx, w, rounding_mode="floor").to(torch.float32)
    cx = (top_idx % w).to(torch.float32)
    valid_center = top_scores > -math.inf
    yy = torch.arange(h, dtype=torch.float32, device=offsets.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=offsets.device)[None, :]
    py = yy + offsets[0]
    px = xx + offsets[1]
    d2 = (py[..., None] - cy) ** 2 + (px[..., None] - cx) ** 2
    d2 = torch.where(valid_center, d2, torch.full_like(d2, math.inf))
    assign = torch.argmin(d2, dim=-1).to(torch.int32)
    has_center = torch.isfinite(d2.amin(dim=-1))
    inst = torch.where(thing_mask & has_center, assign + 1, torch.zeros_like(assign))
    return inst, top_scores


def panoptic_deeplab_fusion(sem_logits: torch.Tensor, instance_ids: torch.Tensor,
                            thing_class_mask: torch.Tensor,
                            label_divisor: int = 1000) -> torch.Tensor:
    """Merge one image's semantic logits (C, H, W) and instance ids (H, W)
    (0 = stuff): each instance takes the majority semantic label of its
    pixels; panoptic id = label * divisor + instance id on thing pixels.
    The vote counts 129 instance slots, as the JAX package does."""
    num_classes = sem_logits.shape[0]
    sem = torch.argmax(sem_logits, dim=0).to(torch.int32)
    is_thing_pixel = thing_class_mask[sem.long()]
    max_inst = 129
    ids = instance_ids.long()
    inside = ids < max_inst
    key = (ids * num_classes + sem.long())[inside]
    votes = torch.bincount(key, minlength=max_inst * num_classes).reshape(max_inst, num_classes)
    inst_label = torch.argmax(votes, dim=-1).to(torch.int32)
    sem_final = torch.where((instance_ids > 0) & is_thing_pixel,
                            inst_label[ids.clamp(max=max_inst - 1)], sem)
    return sem_final * label_divisor + torch.where(is_thing_pixel, instance_ids.to(torch.int32),
                                                   torch.zeros_like(sem))
