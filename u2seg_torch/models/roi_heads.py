"""ROI heads (counterpart of ``u2seg_tpu/models/roi_heads.py``).

Box heads (convs with their norm, then FCs), the class-select mask head,
``fast_rcnn_inference``, proposal labelling and sampling, mask targets from
box-relative patches, and the Standard / Cascade heads with their inference
and training branches for boxes, masks and keypoints. Pooled features travel
as ``(R, S, S, C)``, as in the JAX package; the heads flatten them the NCHW
way (C, S, S) so d2's ``fc1`` weight layout holds. Module names are
detectron2's (``box_head.{k}.conv1.norm``, ``box_head.{k}.fc1``,
``box_predictor.{k}.cls_score``, ``mask_head.mask_fcn1.norm``,
``mask_head.deconv``, ``keypoint_head.conv_fcn1``).

One departure from the JAX package: its mask head takes a ``norm`` and never
applies it (its convs keep their bias). The port's applies it as detectron2
does (no conv bias, then the norm, then relu), so the GN and SyncBN mask
heads of the zoo load detectron2's weights; with ``norm=""`` the two heads
are the same function.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from u2seg_torch.config import ROIHeadsConfig
from u2seg_torch.models import matcher, sampling
from u2seg_torch.models.fpn import FPN_STRIDES
from u2seg_torch.models.keypoint_head import (KRCNNConvDeconvUpsampleHead,
                                              keypoint_rcnn_inference,
                                              keypoint_rcnn_loss)
from u2seg_torch.models.layers import Conv2d, ConvTranspose2d, Linear
from u2seg_torch.ops import losses as L
from u2seg_torch.ops.nms import batched_nms, topk_stable
from u2seg_torch.ops.norms import get_norm
from u2seg_torch.ops.roi_align import multilevel_roi_align, roi_align
from u2seg_torch.ops.roi_align_ml import (multilevel_roi_align_kernel,
                                          multilevel_roi_align_train)
from u2seg_torch.structures import boxes as box_ops
from u2seg_torch.structures.instances import Detections, GtInstances
from u2seg_torch.utils.spans import span


class _ScaleGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def scale_gradient(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Identity whose gradient is multiplied by ``scale`` (between cascade
    stages: 1 / number of stages)."""
    return _ScaleGradient.apply(x, scale)


class FastRCNNConvFCHead(nn.Module):
    """3x3 convs (each: bias only without a norm, then the norm, then relu),
    flatten, FCs (u2seg: 2 x FC-1024) on (R, S, S, C) input."""

    def __init__(self, in_channels: int, resolution: int, num_conv: int = 0,
                 num_fc: int = 2, fc_dim: int = 1024, conv_dim: int = 256,
                 norm: str = ""):
        super().__init__()
        self.num_conv, self.num_fc = num_conv, num_fc
        ch = in_channels
        for i in range(num_conv):
            self.add_module(f"conv{i + 1}", Conv2d(
                ch, conv_dim, 3, padding=1, bias=not norm,
                norm=get_norm(norm, conv_dim), activation=F.relu))
            ch = conv_dim
        dim = ch * resolution * resolution
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", Linear(dim, fc_dim))
            dim = fc_dim
        self.out_dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(self.num_conv):
            x = getattr(self, f"conv{i + 1}")(x)
        x = x.reshape(x.shape[0], -1)                       # NCHW flatten (d2 fc1)
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
        self.num_conv = num_conv
        ch = in_channels
        for i in range(num_conv):
            self.add_module(f"mask_fcn{i + 1}", Conv2d(
                ch, conv_dim, 3, padding=1, bias=not norm,
                norm=get_norm(norm, conv_dim), activation=F.relu))
            ch = conv_dim
        self.deconv = ConvTranspose2d(ch, conv_dim, 2, stride=2)
        self.predictor = Conv2d(conv_dim, num_classes, 1)

    def forward(self, x: torch.Tensor,
                class_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (N, S, S, C) -> f32 mask logits (N, 2S, 2S, 1 | num_classes)."""
        x = x.permute(0, 3, 1, 2)
        for i in range(self.num_conv):
            x = getattr(self, f"mask_fcn{i + 1}")(x)
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


# ---------------------------------------------------------------------------
# Proposal labelling / sampling and mask targets (training)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SampledProposals:
    boxes: torch.Tensor        # (B, S, 4)
    valid: torch.Tensor        # (B, S) bool
    is_fg: torch.Tensor        # (B, S) bool
    gt_classes: torch.Tensor   # (B, S) int64, num_classes for background
    gt_idx: torch.Tensor       # (B, S) int64 matched gt row (junk for bg)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (B, N, ...), idx: (B, M) -> (B, M, ...): rows idx[b] of x[b]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def add_ground_truth_to_proposals(prop_boxes, prop_scores, prop_valid,
                                  gt: GtInstances):
    """Append the gt boxes to the proposal set (score 10, "logit of ~1")."""
    gt_score = torch.where(gt.valid, 10.0, -float("inf")).to(prop_scores.dtype)
    return (torch.cat([prop_boxes, gt.boxes], dim=1),
            torch.cat([prop_scores, gt_score], dim=1),
            torch.cat([prop_valid, gt.valid], dim=1))


def _match_boxes(boxes, valid, gt: GtInstances, iou_threshold: float):
    iou = box_ops.pairwise_iou(gt.boxes, boxes)                  # (B, G, K)
    iou = torch.where(valid[:, None, :], iou, torch.zeros_like(iou))
    return matcher.match(iou, gt.valid, (iou_threshold,), (0, 1), False)


def label_and_sample_proposals(
    prop_boxes, prop_valid, gt: GtInstances, iou_threshold: float,
    num_samples: int, positive_fraction: float, num_classes: int,
    generator: Optional[torch.Generator] = None,
) -> SampledProposals:
    """Match proposals to gt at one IoU threshold, then sample a fixed-size
    fg/bg batch per image. Background slots get class id ``num_classes``."""
    midx, mlabel = _match_boxes(prop_boxes, prop_valid, gt, iou_threshold)
    # invalid proposals must never be sampled
    mlabel = torch.where(prop_valid, mlabel, -1)
    sidx, svalid, spos = sampling.subsample_labels(
        mlabel, num_samples, positive_fraction, generator)
    sgt_idx = torch.gather(midx, 1, sidx)
    cls = torch.where(spos & svalid, torch.gather(gt.classes.long(), 1, sgt_idx),
                      num_classes)
    return SampledProposals(_take(prop_boxes, sidx), svalid, spos, cls, sgt_idx)


def match_and_label_boxes(boxes, valid, gt: GtInstances, iou_threshold: float,
                          num_classes: int):
    """Cascade stages > 0: re-match the refined boxes without re-sampling.
    Returns (gt_classes, gt_idx, is_fg)."""
    midx, mlabel = _match_boxes(boxes, valid, gt, iou_threshold)
    fg = (mlabel == 1) & valid
    cls = torch.where(fg, torch.gather(gt.classes.long(), 1, midx), num_classes)
    return cls, midx, fg


def mask_targets_from_patches(
    patches: torch.Tensor,     # (N, P, P) gt masks cropped to their gt box
    gt_boxes: torch.Tensor,    # (N, 4) the boxes the patches are relative to
    roi_boxes: torch.Tensor,   # (N, 4) proposal boxes to extract targets for
    out_size: int,
) -> torch.Tensor:
    """Resample gt-box-relative mask patches at proposal boxes -> (N, out,
    out): the proposal box in patch coordinates, then an aligned ROIAlign
    (2 x 2 samples) of patch n at box n."""
    n, p, _ = patches.shape
    gw = torch.clamp(gt_boxes[:, 2] - gt_boxes[:, 0], min=1e-4)
    gh = torch.clamp(gt_boxes[:, 3] - gt_boxes[:, 1], min=1e-4)
    sx = p / gw
    sy = p / gh
    pboxes = torch.stack([
        (roi_boxes[:, 0] - gt_boxes[:, 0]) * sx,
        (roi_boxes[:, 1] - gt_boxes[:, 1]) * sy,
        (roi_boxes[:, 2] - gt_boxes[:, 0]) * sx,
        (roi_boxes[:, 3] - gt_boxes[:, 1]) * sy], dim=-1)
    out = roi_align(patches[..., None], pboxes,
                    torch.arange(n, dtype=torch.int32, device=patches.device),
                    out_size, 1.0, sampling_ratio=2)
    return out[..., 0]


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
    """Box, mask and keypoint branches with separate poolers. ``forward``
    returns ``Detections``, or with ``train`` the loss dict."""

    def __init__(self, cfg: ROIHeadsConfig, in_channels: int,
                 compute_dtype: torch.dtype = torch.float32,
                 mask_fg_capacity: int = 128):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.mask_fg_capacity = mask_fg_capacity
        self._build_box_branch(in_channels)
        if cfg.mask_on:
            m = cfg.mask_head
            self.mask_head = MaskRCNNConvUpsampleHead(
                in_channels, 1 if m.cls_agnostic_mask else cfg.num_classes,
                m.num_conv, m.conv_dim, m.norm)
        if cfg.keypoint_on:
            k = cfg.keypoint_head
            self.keypoint_head = KRCNNConvDeconvUpsampleHead(
                in_channels, k.num_keypoints, k.conv_dims)

    def _new_box_head(self, in_channels):
        b = self.cfg.box_head
        return FastRCNNConvFCHead(in_channels, b.pooler_resolution, b.num_conv,
                                  b.num_fc, b.fc_dim, b.conv_dim, b.norm)

    def _build_box_branch(self, in_channels):
        c = self.cfg
        self.box_head = self._new_box_head(in_channels)
        self.box_predictor = FastRCNNOutputLayers(
            self.box_head.out_dim, c.num_classes, c.cls_agnostic_bbox_reg)

    def _strides(self) -> List[int]:
        return [FPN_STRIDES[f] for f in self.cfg.in_features]

    def _pool(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor,
              resolution: int, sampling_ratio: int,
              train: bool = False) -> torch.Tensor:
        """boxes: (B, K, 4) -> pooled (B*K, R, R, C).

        ``pooler_impl``: "pallas" is the multilevel ROIAlign kernel (its
        plain twin on the CPU), emitting the heads' compute dtype, or with
        ``train`` the differentiable kernel pair emitting f32; "gather" the
        gather pooler (f32, differentiable); "auto" the kernels on cuda,
        gather on CPU."""
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
        if impl == "pallas" and train:
            return multilevel_roi_align_train(
                feats, flat, bidx, resolution, tuple(self._strides()),
                sampling_ratio=sampling_ratio)
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
        with span("u2s.roi_heads.stage0"):
            scores, deltas = self._run_box(self.box_head, self.box_predictor,
                                           features, rpn_boxes)
        probs = torch.softmax(scores, dim=-1).reshape(b, k, -1)
        pred = box_ops.apply_deltas(deltas.reshape(b, k, -1), rpn_boxes,
                                    c.bbox_reg_weights)
        return pred, probs

    # ---- training ----

    def _box_losses(self, scores, deltas, proposals: SampledProposals,
                    matched_gt_boxes, reg_weights):
        """Softmax CE on all samples + smooth-L1 on the foreground ones."""
        c = self.cfg
        b, s = proposals.valid.shape
        cls_loss = L.softmax_ce(scores.reshape(b, s, -1), proposals.gt_classes)
        cls_loss = (cls_loss * proposals.valid).sum()
        tgt = box_ops.get_deltas(proposals.boxes, matched_gt_boxes, reg_weights)
        d = deltas.reshape(b, s, -1)
        if not c.cls_agnostic_bbox_reg:
            idx = torch.clamp(proposals.gt_classes, 0, c.num_classes - 1)
            d = torch.gather(d.reshape(b, s, c.num_classes, 4), 2,
                             idx[..., None, None].expand(-1, -1, 1, 4))[..., 0, :]
        else:
            d = d[..., :4]
        reg = L.smooth_l1(d, tgt, c.smooth_l1_beta)
        reg_loss = (reg.sum(-1) * proposals.is_fg).sum()
        normalizer = torch.clamp(proposals.valid.sum(), min=1.0)
        return {"loss_cls": cls_loss / normalizer,
                "loss_box_reg": reg_loss / normalizer}

    def _select_mask_rois(self, proposals: SampledProposals):
        """The first ``mask_fg_capacity`` foreground slots per image (the
        sampling was already random): a stable sort, fg first."""
        order = torch.sort((~proposals.is_fg).to(torch.int8), dim=1,
                           stable=True)[1]
        idx = order[:, :self.mask_fg_capacity]
        return idx, torch.gather(proposals.is_fg, 1, idx)

    def _mask_loss(self, features, proposals: SampledProposals, gt: GtInstances):
        c = self.cfg
        b = proposals.valid.shape[0]
        midx, mvalid = self._select_mask_rois(proposals)          # (B, cap)
        cap = midx.shape[1]
        mboxes = _take(proposals.boxes, midx)
        pooled = self._pool(features, mboxes, c.mask_head.pooler_resolution,
                            c.mask_head.pooler_sampling_ratio, train=True)
        mgt_idx = torch.gather(proposals.gt_idx, 1, midx)
        mcls = torch.gather(proposals.gt_classes, 1, midx)
        n_mask_cls = 1 if c.mask_head.cls_agnostic_mask else c.num_classes
        sel_cls = torch.clamp(mcls, 0, n_mask_cls - 1).reshape(-1)
        logits = self.mask_head(pooled.to(self.compute_dtype), sel_cls)
        out_size = logits.shape[1]
        # the matched gt's patch and box per slot (an index gather)
        targets = mask_targets_from_patches(
            _take(gt.masks, mgt_idx).flatten(0, 1).float(),
            _take(gt.boxes, mgt_idx).flatten(0, 1), mboxes.flatten(0, 1),
            out_size)
        targets = (targets > 0.5).float().reshape(b, cap, out_size, out_size)
        per_px = L.bce_with_logits(logits.reshape(b, cap, out_size, out_size),
                                   targets)
        per_roi = per_px.mean(dim=(-2, -1))
        num_fg = torch.clamp(mvalid.sum(), min=1.0)
        return {"loss_mask": (per_roi * mvalid).sum() / num_fg}

    def _keypoint_loss(self, features, proposals: SampledProposals,
                       gt: GtInstances):
        """Foreground proposals whose matched gt has a visible keypoint inside
        the proposal box, the first ``mask_fg_capacity`` of them per image
        (a stable sort, wanted first), through the keypoint head."""
        c = self.cfg
        k = c.keypoint_head
        b = proposals.valid.shape[0]
        boxes = proposals.boxes
        kp_all = _take(gt.keypoints, proposals.gt_idx)           # (B, S, Kp, 3)
        x, y = kp_all[..., 0], kp_all[..., 1]
        inside = ((x >= boxes[..., None, 0]) & (x <= boxes[..., None, 2])
                  & (y >= boxes[..., None, 1]) & (y <= boxes[..., None, 3])
                  & (kp_all[..., 2] > 0))
        want = proposals.is_fg & inside.any(-1)
        order = torch.sort((~want).to(torch.int8), dim=1, stable=True)[1]
        kidx = order[:, :self.mask_fg_capacity]
        live = torch.gather(want, 1, kidx)
        kboxes = _take(boxes, kidx)
        pooled = self._pool(features, kboxes, k.pooler_resolution,
                            k.pooler_sampling_ratio, train=True)
        logits = self.keypoint_head(pooled.to(self.compute_dtype))
        loss = keypoint_rcnn_loss(
            logits, _take(kp_all, kidx).flatten(0, 1), kboxes.reshape(-1, 4),
            live.reshape(-1), normalizer=k.normalizer)
        return {"loss_keypoint": loss * k.loss_weight}

    def _keypoint_inference(self, features, det: Detections) -> Detections:
        k = self.cfg.keypoint_head
        b, n = det.valid.shape
        pooled = self._pool(features, det.boxes, k.pooler_resolution,
                            k.pooler_sampling_ratio)
        logits = self.keypoint_head(pooled.to(self.compute_dtype))
        kp = keypoint_rcnn_inference(logits, det.boxes.reshape(-1, 4))
        return dataclasses.replace(det, keypoints=kp.reshape(b, n, *kp.shape[1:]))

    def _extra_losses(self, features, proposals: SampledProposals,
                      gt: GtInstances) -> Dict[str, torch.Tensor]:
        """The mask and keypoint losses on the first stage's samples."""
        c = self.cfg
        out = {}
        with span("u2s.roi_heads.mask"):
            if c.mask_on and gt.masks is not None:
                out.update(self._mask_loss(features, proposals, gt))
            if c.keypoint_on and gt.keypoints is not None:
                out.update(self._keypoint_loss(features, proposals, gt))
        return out

    def _sample(self, rpn_boxes, rpn_scores, rpn_valid, gt, iou, generator):
        c = self.cfg
        with span("u2s.roi_heads.sample"):
            boxes, _, valid = add_ground_truth_to_proposals(
                rpn_boxes, rpn_scores, rpn_valid, gt)
            return label_and_sample_proposals(
                boxes, valid, gt, iou, c.batch_size_per_image, c.positive_fraction,
                c.num_classes, generator)

    def losses(self, features, rpn_boxes, rpn_scores, rpn_valid, image_sizes,
               gt: GtInstances, generator=None) -> Dict[str, torch.Tensor]:
        c = self.cfg
        proposals = self._sample(rpn_boxes, rpn_scores, rpn_valid, gt,
                                 c.iou_thresholds[0], generator)
        with span("u2s.roi_heads.stage0"):
            pooled = self._pool(features, proposals.boxes,
                                c.box_head.pooler_resolution,
                                c.box_head.pooler_sampling_ratio, train=True)
            scores, deltas = self.box_predictor(
                self.box_head(pooled.to(self.compute_dtype)))
            out = self._box_losses(scores, deltas, proposals,
                                   _take(gt.boxes, proposals.gt_idx),
                                   c.bbox_reg_weights)
        out.update(self._extra_losses(features, proposals, gt))
        return out

    def forward(self, features, rpn_boxes, rpn_scores, rpn_valid,
                image_sizes, gt: Optional[GtInstances] = None,
                train: bool = False, generator=None):
        c = self.cfg
        if train:
            if gt is None:
                raise ValueError("training needs gt instances")
            return self.losses(features, rpn_boxes, rpn_scores, rpn_valid,
                               image_sizes, gt, generator)
        pred_boxes, probs = self.forward_box(features, rpn_boxes, image_sizes)
        det = fast_rcnn_inference(
            pred_boxes, probs, rpn_valid, image_sizes, c.score_thresh_test,
            c.nms_thresh_test, c.detections_per_image)
        if c.mask_on:
            with span("u2s.roi_heads.mask"):
                det = self._mask_inference(features, det)
        if c.keypoint_on:
            det = self._keypoint_inference(features, det)
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
        """The next stage's boxes; they carry no gradient."""
        b, k = boxes.shape[:2]
        new = box_ops.apply_deltas(deltas.reshape(b, k, -1)[..., :4], boxes,
                                   self.cfg.cascade_bbox_reg_weights[stage])
        return box_ops.clip(new, image_sizes).detach()

    def losses(self, features, rpn_boxes, rpn_scores, rpn_valid, image_sizes,
               gt: GtInstances, generator=None) -> Dict[str, torch.Tensor]:
        c = self.cfg
        num_stages = len(c.cascade_ious)
        proposals = self._sample(rpn_boxes, rpn_scores, rpn_valid, gt,
                                 c.cascade_ious[0], generator)
        boxes, valid = proposals.boxes, proposals.valid
        out: Dict[str, torch.Tensor] = {}
        cur = proposals
        for stage in range(num_stages):
            with span(f"u2s.roi_heads.stage{stage}"):
                if stage > 0:
                    cls, gidx, fg = match_and_label_boxes(
                        boxes, valid, gt, c.cascade_ious[stage], c.num_classes)
                    cur = SampledProposals(boxes, valid, fg, cls, gidx)
                pooled = self._pool(features, boxes, c.box_head.pooler_resolution,
                                    c.box_head.pooler_sampling_ratio, train=True)
                pooled = scale_gradient(pooled, 1.0 / num_stages)
                scores, deltas = self.box_predictor[stage](
                    self.box_head[stage](pooled.to(self.compute_dtype)))
                stage_losses = self._box_losses(
                    scores, deltas, cur, _take(gt.boxes, cur.gt_idx),
                    c.cascade_bbox_reg_weights[stage])
                out.update({f"{k}_stage{stage}": v for k, v in stage_losses.items()})
                if stage < num_stages - 1:
                    boxes = self._refine(deltas, boxes, stage, image_sizes)
        out.update(self._extra_losses(features, proposals, gt))
        return out

    def forward_box(self, features, rpn_boxes, image_sizes):
        c = self.cfg
        num_stages = len(c.cascade_ious)
        boxes = rpn_boxes
        b, k = boxes.shape[:2]
        probs = []
        deltas = None
        for stage in range(num_stages):
            with span(f"u2s.roi_heads.stage{stage}"):
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
