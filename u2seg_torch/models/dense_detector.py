"""One-stage dense detectors: RetinaNet and FCOS (counterpart of
``u2seg_tpu/models/dense_detector.py``).

``DenseHead`` is the shared 4-conv classification and box towers over the
pyramid levels; ``RetinaNet`` and ``FCOS`` take FPN features to the loss
dict or to fixed-capacity ``Detections`` (top-k candidates, then one
class-aware NMS); ``DenseDetectorMetaArch`` adds the ResNet-FPN backbone
(res3-res5 laterals, the ``p6p7`` top block) and pixel normalization.
Module names are detectron2's: ``head.cls_subnet.{i}``,
``head.bbox_subnet.{i}``, ``head.cls_score``, ``head.bbox_pred`` and, for
FCOS, ``head.ctrness``.

The heads compute in f32 whatever ``compute_dtype`` says, as the JAX
package's (their convs have no dtype, so flax promotes the bf16 levels to
the f32 of their parameters). A conv's (B, A * C, H, W) output is flattened
in (H, W, A, C) order, the order of the anchors and of the JAX package's
NHWC maps. Every top-k keeps the lower index first among equal scores.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from u2seg_torch.config import AnchorConfig, FCOSConfig, ModelConfig, RetinaNetConfig
from u2seg_torch.models import matcher
from u2seg_torch.models.anchors import multilevel_anchors
from u2seg_torch.models.backbone import build_backbone
from u2seg_torch.models.fpn import FPN_STRIDES
from u2seg_torch.models.layers import Conv2d
from u2seg_torch.models.rcnn import ImageModel, check_mode, torch_dtype
from u2seg_torch.ops import losses as L
from u2seg_torch.ops.nms import batched_nms, topk_stable
from u2seg_torch.ops.norms import get_norm
from u2seg_torch.structures import boxes as box_ops
from u2seg_torch.structures.instances import Detections, GtInstances

# the JAX RetinaNet's own anchors (3 sizes x 3 ratios per level), not the
# config's RPN anchors
RETINANET_ANCHORS = AnchorConfig(
    sizes=((32, 40, 50), (64, 80, 101), (128, 161, 203), (256, 322, 406),
           (512, 645, 812)))


def _flatten(x: torch.Tensor, last: int) -> torch.Tensor:
    """(B, A * last, H, W) -> (B, H * W * A, last)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, last)


class DenseHead(nn.Module):
    """Shared classification and box towers: per level, 4 x (3x3 conv,
    optional norm, relu), then ``cls_score`` / ``bbox_pred`` (and ``ctrness``)
    3x3 convs. One norm module serves every level, so in training a BN's
    running statistics take one update per level, as in the JAX package;
    ``shared_levels_bn`` normalizes all levels with one call instead
    (``projects.rethinking_bn.shared_levels_norm``), layer by layer."""

    def __init__(self, in_channels: int, num_classes: int, num_anchors: int,
                 conv_dims: Sequence[int] = (256,) * 4, prior_prob: float = 0.01,
                 with_centerness: bool = False, norm: str = "",
                 shared_levels_bn: bool = False):
        super().__init__()
        self.shared_levels_bn = shared_levels_bn and bool(norm)
        self.prior_prob = prior_prob
        for tower in ("cls_subnet", "bbox_subnet"):
            layers: List[nn.Module] = []
            ch = in_channels
            for d in conv_dims:
                layers.append(Conv2d(ch, d, 3, padding=1))
                if norm:
                    layers.append(get_norm(norm, d))
                layers.append(nn.ReLU())
                ch = d
            self.add_module(tower, nn.Sequential(*layers))
        self.cls_score = Conv2d(ch, num_anchors * num_classes, 3, padding=1)
        self.bbox_pred = Conv2d(ch, num_anchors * 4, 3, padding=1)
        self.ctrness = (Conv2d(ch, num_anchors, 3, padding=1)
                        if with_centerness else None)

    def forward(self, features: Sequence[torch.Tensor]):
        """NCHW levels -> per-level (logits, box outputs, centerness) lists,
        NCHW f32."""
        if self.shared_levels_bn:
            return self._forward_shared(features)
        logits, boxes, ctr = [], [], []
        for x in features:
            x = x.float()
            logits.append(self.cls_score(self.cls_subnet(x)))
            t = self.bbox_subnet(x)
            boxes.append(self.bbox_pred(t))
            if self.ctrness is not None:
                ctr.append(self.ctrness(t))
        return logits, boxes, ctr


    def _forward_shared(self, features: Sequence[torch.Tensor]):
        """The towers layer by layer over all levels; each norm once over
        all of them."""
        from u2seg_torch.projects.rethinking_bn import shared_levels_norm

        def tower(seq):
            feats = [x.float() for x in features]
            for layer in seq:
                if isinstance(layer, (Conv2d, nn.ReLU)):
                    feats = [layer(f) for f in feats]
                else:
                    feats = shared_levels_norm(layer, feats)
            return feats

        cls_feats, box_feats = tower(self.cls_subnet), tower(self.bbox_subnet)
        return ([self.cls_score(f) for f in cls_feats], [self.bbox_pred(f) for f in box_feats],
                [self.ctrness(f) for f in box_feats] if self.ctrness is not None else [])


def _nms_detections(boxes, scores, classes, image_sizes, nms_thresh: float,
                    max_detections: int) -> Detections:
    """Clip the candidates, one class-aware NMS per image, keep the top
    ``max_detections``: (B, M, 4) boxes, (B, M) scores (-inf for none)."""
    boxes = box_ops.clip(boxes, image_sizes)
    keep, valid = batched_nms(boxes, scores, classes, nms_thresh, max_detections)
    keep = keep.long()
    scores = torch.gather(scores, 1, keep)
    return Detections(
        boxes=torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 4)),
        scores=torch.where(valid, scores, torch.zeros_like(scores)),
        classes=torch.gather(classes, 1, keep), valid=valid)


class RetinaNet(nn.Module):
    """Anchor-based one-stage detector over FPN features (p3-p7)."""

    def __init__(self, cfg: RetinaNetConfig, in_channels: int,
                 anchor_cfg: AnchorConfig = RETINANET_ANCHORS):
        super().__init__()
        self.cfg = cfg
        self.anchor_cfg = anchor_cfg
        num_anchors = len(anchor_cfg.aspect_ratios) * len(anchor_cfg.sizes[0])
        self.head = DenseHead(in_channels, cfg.num_classes, num_anchors,
                              norm=cfg.head_norm, shared_levels_bn=cfg.head_shared_bn)

    def forward(self, features: Dict[str, torch.Tensor], image_sizes: torch.Tensor,
                gt: Optional[GtInstances] = None, train: bool = False):
        c = self.cfg
        feats = [features[f] for f in c.in_features]
        logits_l, deltas_l, _ = self.head(feats)
        logits_l = [_flatten(x, c.num_classes) for x in logits_l]
        deltas_l = [_flatten(x, 4) for x in deltas_l]
        anchors = multilevel_anchors(
            [f.shape[2:4] for f in feats], [FPN_STRIDES[n] for n in c.in_features],
            self.anchor_cfg.sizes, self.anchor_cfg.aspect_ratios,
            self.anchor_cfg.offset, device=feats[0].device)
        if train:
            return self._losses(torch.cat(anchors), torch.cat(logits_l, 1),
                                torch.cat(deltas_l, 1), gt)
        return self._inference(anchors, logits_l, deltas_l, image_sizes)

    def _losses(self, anchors, logits, deltas, gt: GtInstances):
        """Focal loss over the anchors that are not ignored, smooth-L1 on the
        foreground ones, both over the number of foreground anchors."""
        c = self.cfg
        iou = box_ops.pairwise_iou(gt.boxes, anchors)               # (B, G, N)
        midx, mlabel = matcher.match(iou, gt.valid, c.iou_thresholds,
                                     (0, -1, 1), allow_low_quality_matches=True)
        fg = mlabel == 1
        cls = torch.where(fg, torch.gather(gt.classes.long(), 1, midx), c.num_classes)
        target = F.one_hot(cls, c.num_classes + 1)[..., :-1].float()
        cls_loss = (L.sigmoid_focal_loss(logits, target, c.focal_alpha, c.focal_gamma)
                    * (mlabel >= 0)[..., None]).sum()
        matched = torch.gather(gt.boxes, 1, midx[..., None].expand(-1, -1, 4))
        tgt = box_ops.get_deltas(anchors.expand_as(matched), matched, c.box_reg_weights)
        reg = L.smooth_l1(deltas, tgt, c.smooth_l1_beta)
        reg_loss = (reg.sum(-1) * fg).sum()
        norm = torch.clamp(fg.sum(), min=1.0)
        return {"loss_cls": cls_loss / norm, "loss_box_reg": reg_loss / norm}

    def _inference(self, anchors, logits_l, deltas_l, image_sizes) -> Detections:
        """Per level the top ``topk_candidates`` (anchor, class) pairs by
        probability, decoded; then NMS over all levels."""
        c = self.cfg
        b = logits_l[0].shape[0]
        all_boxes, all_scores, all_cls = [], [], []
        for anc, logit, delta in zip(anchors, logits_l, deltas_l):
            probs = torch.sigmoid(logit.reshape(b, -1))
            topv, topi = topk_stable(probs, min(c.topk_candidates, probs.shape[1]))
            anchor_idx = torch.div(topi, c.num_classes, rounding_mode="floor")
            sel_delta = torch.gather(delta, 1, anchor_idx[..., None].expand(-1, -1, 4))
            all_boxes.append(box_ops.apply_deltas(sel_delta, anc[anchor_idx],
                                                  c.box_reg_weights))
            all_scores.append(torch.where(topv > c.score_thresh, topv,
                                          torch.full_like(topv, -float("inf"))))
            all_cls.append((topi % c.num_classes).to(torch.int32))
        return _nms_detections(torch.cat(all_boxes, 1), torch.cat(all_scores, 1),
                               torch.cat(all_cls, 1), image_sizes, c.nms_thresh,
                               c.max_detections)


class FCOS(nn.Module):
    """Anchor-free one-stage detector: per-point ltrb distances (exp of the
    box output times the stride) and centerness, center-sampling
    assignment to the smallest box in range."""

    def __init__(self, cfg: FCOSConfig, in_channels: int):
        super().__init__()
        self.cfg = cfg
        self.head = DenseHead(in_channels, cfg.num_classes, 1, with_centerness=True,
                              norm=cfg.head_norm)

    def forward(self, features: Dict[str, torch.Tensor], image_sizes: torch.Tensor,
                gt: Optional[GtInstances] = None, train: bool = False):
        c = self.cfg
        feats = [features[f] for f in c.in_features]
        logits_l, reg_l, ctr_l = self.head(feats)
        dev = feats[0].device
        points, strides, ranges = [], [], []
        for f, name, rng in zip(feats, c.in_features, c.size_ranges):
            s = FPN_STRIDES[name]
            h, w = f.shape[2:4]
            ys = (torch.arange(h, device=dev) + 0.5) * s
            xs = (torch.arange(w, device=dev) + 0.5) * s
            yy, xx = torch.meshgrid(ys, xs, indexing="ij")
            points.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], -1))
            strides.append(torch.full((h * w,), float(s), device=dev))
            ranges.append(torch.tensor(rng, dtype=torch.float32, device=dev).expand(h * w, 2))
        pts, pstr, prng = torch.cat(points), torch.cat(strides), torch.cat(ranges)
        logits = torch.cat([_flatten(x, c.num_classes) for x in logits_l], 1)
        reg = torch.exp(torch.cat([_flatten(x, 4) for x in reg_l], 1)) * pstr[None, :, None]
        ctr = torch.cat([_flatten(x, 1)[..., 0] for x in ctr_l], 1)
        if train:
            return self._losses(pts, pstr, prng, logits, reg, ctr, gt)
        return self._inference(pts, logits, reg, ctr, image_sizes)

    def _assign(self, pts, pstr, prng, gt: GtInstances):
        """-> (matched gt (B, P), foreground (B, P), target ltrb (B, P, 4))."""
        x, y = pts[:, 0][None, :, None], pts[:, 1][None, :, None]   # (1, P, 1)
        gb = gt.boxes[:, None]                                       # (B, 1, G, 4)
        x0, y0, x1, y1 = gb[..., 0], gb[..., 1], gb[..., 2], gb[..., 3]
        ltrb = torch.stack([x - x0, y - y0, x1 - x, y1 - y], -1)     # (B, P, G, 4)
        inside = ltrb.amin(-1) > 0
        rad = self.cfg.center_sampling_radius * pstr[None, :, None]
        near = ((x - (x0 + x1) / 2).abs() < rad) & ((y - (y0 + y1) / 2).abs() < rad)
        maxd = ltrb.amax(-1)
        in_range = (maxd >= prng[None, :, 0:1]) & (maxd <= prng[None, :, 1:2])
        ok = inside & near & in_range & gt.valid[:, None, :]
        areas = torch.where(ok, box_ops.area(gt.boxes)[:, None, :],
                            torch.full_like(maxd, float("inf")))
        gidx = areas.argmin(-1)                     # the first index of the minimum
        fg = torch.isfinite(areas.amin(-1))
        tgt = torch.gather(ltrb, 2, gidx[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
        return gidx, fg, tgt

    def _losses(self, pts, pstr, prng, logits, reg, ctr, gt: GtInstances):
        c = self.cfg
        gidx, fg, tgt = self._assign(pts, pstr, prng, gt)
        cls = torch.where(fg, torch.gather(gt.classes.long(), 1, gidx), c.num_classes)
        target = F.one_hot(cls, c.num_classes + 1)[..., :-1].float()
        cls_loss = L.sigmoid_focal_loss(logits, target, c.focal_alpha, c.focal_gamma).sum()
        px, py = pts[:, 0], pts[:, 1]

        def to_boxes(d):
            return torch.stack([px - d[..., 0], py - d[..., 1],
                                px + d[..., 2], py + d[..., 3]], -1)

        reg_loss = (L.giou_loss(to_boxes(reg), to_boxes(tgt)) * fg).sum()
        lr = torch.stack([tgt[..., 0], tgt[..., 2]], -1)
        tb = torch.stack([tgt[..., 1], tgt[..., 3]], -1)
        ctr_tgt = torch.sqrt(torch.clamp(
            (lr.amin(-1) / torch.clamp(lr.amax(-1), min=1e-6))
            * (tb.amin(-1) / torch.clamp(tb.amax(-1), min=1e-6)), 0.0, 1.0))
        ctr_loss = (L.bce_with_logits(ctr, ctr_tgt) * fg).sum()
        norm = torch.clamp(fg.sum(), min=1.0)
        return {"loss_fcos_cls": cls_loss / norm, "loss_fcos_loc": reg_loss / norm,
                "loss_fcos_ctr": ctr_loss / norm}

    def _inference(self, pts, logits, reg, ctr, image_sizes) -> Detections:
        """The top ``topk_candidates`` (point, class) pairs over all levels by
        sqrt(class probability x centerness), decoded; then NMS."""
        c = self.cfg
        b = logits.shape[0]
        probs = torch.sqrt(torch.sigmoid(logits) * torch.sigmoid(ctr)[..., None])
        flat = probs.reshape(b, -1)
        topv, topi = topk_stable(flat, min(c.topk_candidates, flat.shape[1]))
        pt_idx = torch.div(topi, c.num_classes, rounding_mode="floor")
        sel_reg = torch.gather(reg, 1, pt_idx[..., None].expand(-1, -1, 4))
        sel_pts = pts[pt_idx]
        boxes = torch.stack([sel_pts[..., 0] - sel_reg[..., 0],
                             sel_pts[..., 1] - sel_reg[..., 1],
                             sel_pts[..., 0] + sel_reg[..., 2],
                             sel_pts[..., 1] + sel_reg[..., 3]], -1)
        scores = torch.where(topv > c.score_thresh, topv,
                             torch.full_like(topv, -float("inf")))
        return _nms_detections(boxes, scores, (topi % c.num_classes).to(torch.int32),
                               image_sizes, c.nms_thresh, c.max_detections)


class DenseDetectorMetaArch(ImageModel):
    """ResNet-FPN backbone (a ``maxpool`` FPN config becomes res3-res5 with
    the ``p6p7`` top block) + RetinaNet or FCOS, from the whole model config.
    ``forward(images, image_sizes, gt=None, train=False)`` returns
    ``Detections``, or the loss dict."""

    def __init__(self, cfg: ModelConfig, head_name: str = "RetinaNet", input_hw=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = torch_dtype(cfg.compute_dtype)
        fpn = cfg.fpn
        if fpn.top_block != "p6p7":
            fpn = dataclasses.replace(fpn, top_block="p6p7",
                                      in_features=("res3", "res4", "res5"))
        self.backbone = build_backbone(dataclasses.replace(cfg, fpn=fpn), input_hw)
        detector = (RetinaNet(cfg.retinanet, fpn.out_channels) if head_name == "RetinaNet"
                    else FCOS(cfg.fcos, fpn.out_channels))
        # the detector holds no parameter but its head's: registering the head
        # alone names them ``head.*``, as detectron2 does
        self.head = detector.head
        self._detector = (detector,)

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor,
                gt: Optional[GtInstances] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``generator`` is taken for the R-CNN models' call signature; a
        dense detector samples nothing."""
        check_mode(self, train)
        with torch.set_grad_enabled(train):
            return self._detector[0](self.features(images), image_sizes,
                                     gt=gt, train=train)


def RetinaNetDetector(model_cfg: ModelConfig, input_hw=None) -> DenseDetectorMetaArch:
    return DenseDetectorMetaArch(model_cfg, "RetinaNet", input_hw)


def FCOSDetector(model_cfg: ModelConfig, input_hw=None) -> DenseDetectorMetaArch:
    return DenseDetectorMetaArch(model_cfg, "FCOS", input_hw)
