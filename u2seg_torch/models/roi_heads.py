"""ROI heads, inference (counterpart of ``u2seg_tpu/models/roi_heads.py``).

Box heads, the class-select mask head, ``fast_rcnn_inference`` and the
Standard / Cascade heads. Pooled features travel as ``(R, S, S, C)``, as in
the JAX package; the heads flatten them the NCHW way (C, S, S) so d2's
``fc1`` weight layout holds. Module names are detectron2's
(``box_head.{k}.fc1``, ``box_predictor.{k}.cls_score``, ``mask_head.deconv``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from u2seg_torch.config import ROIHeadsConfig
from u2seg_torch.models.fpn import FPN_STRIDES
from u2seg_torch.models.layers import Conv2d, ConvTranspose2d, Linear
from u2seg_torch.ops.nms import batched_nms, topk_stable
from u2seg_torch.ops.roi_align import multilevel_roi_align
from u2seg_torch.ops.roi_align_ml import multilevel_roi_align_kernel
from u2seg_torch.structures import boxes as box_ops
from u2seg_torch.structures.instances import Detections


class FastRCNNConvFCHead(nn.Module):
    """flatten + FCs (u2seg: 2 x FC-1024) on (R, S, S, C) input."""

    def __init__(self, in_channels: int, resolution: int, num_conv: int = 0,
                 num_fc: int = 2, fc_dim: int = 1024):
        super().__init__()
        if num_conv:
            raise NotImplementedError("box-head convs are not ported yet")
        self.num_fc = num_fc
        dim = in_channels * resolution * resolution
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", Linear(dim, fc_dim))
            dim = fc_dim
        self.out_dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)   # NCHW flatten (d2 fc1)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class FastRCNNOutputLayers(nn.Module):
    """Linear cls (C+1) + linear box deltas; both returned in f32."""

    def __init__(self, in_dim: int, num_classes: int,
                 cls_agnostic_bbox_reg: bool = True):
        super().__init__()
        self.cls_score = Linear(in_dim, num_classes + 1)
        self.bbox_pred = Linear(
            in_dim, 4 if cls_agnostic_bbox_reg else 4 * num_classes)

    def forward(self, x):
        return self.cls_score(x).float(), self.bbox_pred(x).float()


class MaskRCNNConvUpsampleHead(nn.Module):
    """4 x conv + 2x deconv + 1x1 predictor that computes only the requested
    class's filter per ROI (``class_idx``): the same numbers as slicing the
    full output, at 1/num_classes of the predictor's work."""

    def __init__(self, in_channels: int, num_classes: int, num_conv: int = 4,
                 conv_dim: int = 256, norm: str = ""):
        super().__init__()
        if norm:
            raise NotImplementedError("the port's mask head has no norm yet")
        self.num_conv = num_conv
        ch = in_channels
        for i in range(num_conv):
            self.add_module(f"mask_fcn{i + 1}", Conv2d(ch, conv_dim, 3, padding=1))
            ch = conv_dim
        self.deconv = ConvTranspose2d(ch, conv_dim, 2, stride=2)
        self.predictor = Conv2d(conv_dim, num_classes, 1)

    def forward(self, x: torch.Tensor,
                class_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (N, S, S, C) -> f32 mask logits (N, 2S, 2S, 1 | num_classes)."""
        x = x.permute(0, 3, 1, 2)
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        x = F.relu(self.deconv(x))
        w = self.predictor.weight[:, :, 0, 0].to(x.dtype)   # (classes, Cin)
        bias = self.predictor.bias.to(x.dtype)
        if class_idx is None or w.shape[0] == 1:
            out = torch.einsum("nchw,oc->nhwo", x, w) + bias
        else:
            cls = class_idx.long()
            out = torch.einsum("nchw,nc->nhw", x, w[cls]) + bias[cls][:, None, None]
            out = out[..., None]
        return out.float()


def fast_rcnn_inference(
    boxes: torch.Tensor,        # (B, K, C*4) or (B, K, 4)
    scores: torch.Tensor,       # (B, K, C+1) softmax probabilities
    prop_valid: torch.Tensor,   # (B, K)
    image_sizes: torch.Tensor,  # (B, 2)
    score_thresh: float,
    nms_thresh: float,
    max_detections: int,
    candidate_topk: int = 2048,
) -> Detections:
    """Per-class score threshold -> top-M candidates -> class-aware NMS ->
    top ``max_detections``. Candidates are mined as in the JAX package:
    classes in blocks of 32, the best (roi, block) pairs by block max, then
    one exact top-M over their expanded scores (exact for BLOCK_KEEP = M)."""
    bsz, k, cp1 = scores.shape
    num_classes = cp1 - 1
    block = 32
    nblocks = (num_classes + block - 1) // block
    pad_c = nblocks * block - num_classes
    block_keep = min(candidate_topk, k * nblocks)

    cls_scores = scores[..., :-1]
    cls_scores = torch.where(prop_valid[..., None], cls_scores,
                             torch.zeros_like(cls_scores))
    if pad_c:
        cls_scores = F.pad(cls_scores, (0, pad_c))
    blocked = cls_scores.reshape(bsz, k * nblocks, block)
    bmax = blocked.amax(dim=-1)
    _, bsel = topk_stable(bmax, block_keep)                   # (B, BK)
    sel = torch.gather(blocked, 1, bsel[..., None].expand(-1, -1, block))
    sel_roi = torch.div(bsel, nblocks, rounding_mode="floor")
    sel_cls0 = (bsel % nblocks) * block

    flat = sel.reshape(bsz, -1)
    flat = torch.where(flat > score_thresh, flat,
                       torch.full_like(flat, -float("inf")))
    m = min(candidate_topk, flat.shape[1])
    top_s, top_i = topk_stable(flat, m)
    grp = torch.div(top_i, block, rounding_mode="floor")
    cand_roi = torch.gather(sel_roi, 1, grp)
    cls_id = torch.gather(sel_cls0, 1, grp) + top_i % block
    cls_id = torch.clamp(cls_id, max=num_classes - 1).to(torch.int32)
    if boxes.shape[-1] == 4:
        cand = torch.gather(boxes, 1, cand_roi[..., None].expand(-1, -1, 4))
    else:
        per_cls = boxes.reshape(bsz, k * num_classes, 4)
        flat_idx = cand_roi * num_classes + cls_id.long()
        cand = torch.gather(per_cls, 1, flat_idx[..., None].expand(-1, -1, 4))
    cand = box_ops.clip(cand, image_sizes)
    keep_idx, keep_valid = batched_nms(cand, top_s, cls_id, nms_thresh,
                                       max_detections)
    keep_idx = keep_idx.long()
    det_boxes = torch.gather(cand, 1, keep_idx[..., None].expand(-1, -1, 4))
    det_scores = torch.gather(top_s, 1, keep_idx)
    det_scores = torch.where(keep_valid, det_scores, torch.zeros_like(det_scores))
    det_cls = torch.gather(cls_id, 1, keep_idx)
    return Detections(boxes=det_boxes, scores=det_scores, classes=det_cls,
                      valid=keep_valid)


class StandardROIHeads(nn.Module):
    """Box + mask branches with separate poolers, inference."""

    def __init__(self, cfg: ROIHeadsConfig, in_channels: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self._build_box_branch(in_channels)
        if cfg.mask_on:
            m = cfg.mask_head
            self.mask_head = MaskRCNNConvUpsampleHead(
                in_channels, 1 if m.cls_agnostic_mask else cfg.num_classes,
                m.num_conv, m.conv_dim, m.norm)
        if cfg.keypoint_on:
            raise NotImplementedError("the keypoint head is not ported yet")

    def _new_box_head(self, in_channels):
        b = self.cfg.box_head
        return FastRCNNConvFCHead(in_channels, b.pooler_resolution, b.num_conv,
                                  b.num_fc, b.fc_dim)

    def _build_box_branch(self, in_channels):
        c = self.cfg
        self.box_head = self._new_box_head(in_channels)
        self.box_predictor = FastRCNNOutputLayers(
            self.box_head.out_dim, c.num_classes, c.cls_agnostic_bbox_reg)

    def _strides(self) -> List[int]:
        return [FPN_STRIDES[f] for f in self.cfg.in_features]

    def _pool(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor,
              resolution: int, sampling_ratio: int) -> torch.Tensor:
        """boxes: (B, K, 4) -> pooled (B*K, R, R, C).

        ``pooler_impl``: "pallas" is the multilevel ROIAlign kernel (its
        plain twin on the CPU), emitting the heads' compute dtype; "gather"
        the gather pooler (f32); "auto" the kernel on cuda, gather on CPU."""
        b, k, _ = boxes.shape
        flat = boxes.reshape(-1, 4)
        bidx = torch.arange(b, dtype=torch.int32,
                            device=boxes.device).repeat_interleave(k)
        # (B, C, H, W) maps in channels-last memory -> NHWC views
        feats = [features[f].contiguous(memory_format=torch.channels_last)
                 .permute(0, 2, 3, 1) for f in self.cfg.in_features]
        impl = self.cfg.pooler_impl
        if impl == "auto":
            impl = "pallas" if boxes.device.type == "cuda" else "gather"
        if impl == "pallas":
            return multilevel_roi_align_kernel(
                feats, flat, bidx, resolution, tuple(self._strides()),
                sampling_ratio=sampling_ratio, out_dtype=self.compute_dtype)
        return multilevel_roi_align(feats, flat, bidx, resolution,
                                    self._strides(), sampling_ratio)

    def _run_box(self, head, predictor, features, boxes):
        c = self.cfg
        pooled = self._pool(features, boxes, c.box_head.pooler_resolution,
                            c.box_head.pooler_sampling_ratio)
        return predictor(head(pooled.to(self.compute_dtype)))

    def _mask_inference(self, features, det: Detections) -> Detections:
        c = self.cfg
        b, k = det.valid.shape
        pooled = self._pool(features, det.boxes, c.mask_head.pooler_resolution,
                            c.mask_head.pooler_sampling_ratio)
        n_mask_cls = 1 if c.mask_head.cls_agnostic_mask else c.num_classes
        cls_idx = torch.clamp(det.classes, 0, n_mask_cls - 1).reshape(-1)
        logits = self.mask_head(pooled.to(self.compute_dtype), cls_idx)
        out_size = logits.shape[1]
        return dataclasses.replace(
            det, mask_logits=logits.reshape(b, k, out_size, out_size))

    def forward_box(self, features, rpn_boxes, image_sizes):
        """-> (pred_boxes (B, K, 4 | 4C), class probabilities (B, K, C+1))."""
        c = self.cfg
        b, k, _ = rpn_boxes.shape
        scores, deltas = self._run_box(self.box_head, self.box_predictor,
                                       features, rpn_boxes)
        probs = torch.softmax(scores, dim=-1).reshape(b, k, -1)
        pred = box_ops.apply_deltas(deltas.reshape(b, k, -1), rpn_boxes,
                                    c.bbox_reg_weights)
        return pred, probs

    def forward(self, features, rpn_boxes, rpn_scores, rpn_valid,
                image_sizes) -> Detections:
        c = self.cfg
        pred_boxes, probs = self.forward_box(features, rpn_boxes, image_sizes)
        det = fast_rcnn_inference(
            pred_boxes, probs, rpn_valid, image_sizes, c.score_thresh_test,
            c.nms_thresh_test, c.detections_per_image)
        if c.mask_on:
            det = self._mask_inference(features, det)
        return det


class CascadeROIHeads(StandardROIHeads):
    """3-stage box refinement with averaged stage scores."""

    def _build_box_branch(self, in_channels):
        c = self.cfg
        self.box_head = nn.ModuleList(
            [self._new_box_head(in_channels) for _ in c.cascade_ious])
        self.box_predictor = nn.ModuleList(
            [FastRCNNOutputLayers(h.out_dim, c.num_classes, True)
             for h in self.box_head])

    def _refine(self, deltas, boxes, stage, image_sizes):
        b, k = boxes.shape[:2]
        new = box_ops.apply_deltas(deltas.reshape(b, k, -1)[..., :4], boxes,
                                   self.cfg.cascade_bbox_reg_weights[stage])
        return box_ops.clip(new, image_sizes)

    def forward_box(self, features, rpn_boxes, image_sizes):
        c = self.cfg
        num_stages = len(c.cascade_ious)
        boxes = rpn_boxes
        b, k = boxes.shape[:2]
        probs = []
        deltas = None
        for stage in range(num_stages):
            scores, deltas = self._run_box(self.box_head[stage],
                                           self.box_predictor[stage],
                                           features, boxes)
            probs.append(torch.softmax(scores, dim=-1).reshape(b, k, -1))
            if stage < num_stages - 1:
                boxes = self._refine(deltas, boxes, stage, image_sizes)
        # averaged stage scores, summed in stage order as the JAX package does
        avg = probs[0]
        for p in probs[1:]:
            avg = avg + p
        avg = avg / num_stages
        pred = box_ops.apply_deltas(deltas.reshape(b, k, -1)[..., :4], boxes,
                                    c.cascade_bbox_reg_weights[-1])
        return pred, avg
