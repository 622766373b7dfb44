"""Region Proposal Network (counterpart of ``u2seg_tpu/models/rpn.py``:
``RPNHead``, ``RPN._predict_proposals`` and, for training, ``RPN._losses``).

Fixed capacities as in the JAX package: per-level pre-NMS top-k, one NMS
over the (level, image) grid, cross-level post-NMS top-k, with validity
masks. Every top-k is a stable descending sort (ties: lower index first),
which is what ``lax.top_k`` returns and what the JAX package's pre-NMS
``approx_max_k`` returns on the CPU for f32 logits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from u2seg_torch.config import AnchorConfig, RPNConfig
from u2seg_torch.models import matcher, sampling
from u2seg_torch.models.anchors import multilevel_anchors
from u2seg_torch.models.fpn import FPN_STRIDES
from u2seg_torch.models.layers import Conv2d
from u2seg_torch.ops import losses as L
from u2seg_torch.ops.nms import nms, topk_stable
from u2seg_torch.structures import boxes as box_ops
from u2seg_torch.structures.instances import GtInstances
from u2seg_torch.utils.spans import span


class RPNHead(nn.Module):
    """Shared 3x3 conv(s) + relu -> (objectness, anchor deltas) 1x1 convs, in
    ``dtype`` (None: the levels' own). ``conv_dims`` as detectron2's
    ``StandardRPNHead`` takes them (-1: the input's channels): one conv is
    ``conv``, several are ``conv.conv0``, ``conv.conv1``, ... each with its
    relu."""

    def __init__(self, in_channels: int, num_anchors: int, dtype=None,
                 conv_dims=(-1,)):
        super().__init__()
        self.dtype = dtype
        if len(conv_dims) == 1:
            ch = in_channels if conv_dims[0] == -1 else conv_dims[0]
            self.conv = Conv2d(in_channels, ch, 3, padding=1, activation=F.relu)
        else:
            self.conv = nn.Sequential()
            ch = in_channels
            for k, dim in enumerate(conv_dims):
                out = ch if dim == -1 else dim
                self.conv.add_module(f"conv{k}", Conv2d(ch, out, 3, padding=1,
                                                        activation=F.relu))
                ch = out
        self.objectness_logits = Conv2d(ch, num_anchors, 1)
        self.anchor_deltas = Conv2d(ch, num_anchors * 4, 1)

    def forward(self, features: List[torch.Tensor]):
        logits, deltas = [], []
        for x in features:
            t = self.conv(x if self.dtype is None else x.to(self.dtype))
            logits.append(self.objectness_logits(t))
            deltas.append(self.anchor_deltas(t))
        return logits, deltas


@dataclasses.dataclass
class RPNOutput:
    proposal_boxes: torch.Tensor   # (B, K, 4) f32
    proposal_scores: torch.Tensor  # (B, K) f32, -inf for invalid
    proposal_valid: torch.Tensor   # (B, K) bool
    losses: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


class RPN(nn.Module):
    def __init__(self, cfg: RPNConfig, anchor_cfg: AnchorConfig,
                 in_channels: int, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.anchor_cfg = anchor_cfg
        self.rpn_head = RPNHead(in_channels, len(anchor_cfg.aspect_ratios), dtype,
                                tuple(cfg.head_conv_dims))

    def forward(self, features: Dict[str, torch.Tensor],
                image_sizes: torch.Tensor, gt: Optional[GtInstances] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> RPNOutput:
        """With ``train`` and ``gt``: also the two RPN losses (anchor
        sampling draws from ``generator``), the train top-k sizes, and
        proposals that carry no gradient."""
        with span("u2s.rpn"):
            return self._forward(features, image_sizes, gt, train, generator)

    def _forward(self, features, image_sizes, gt, train, generator) -> RPNOutput:
        c = self.cfg
        feats = [features[f] for f in c.in_features]
        logits_nchw, deltas_nchw = self.rpn_head(feats)
        b = feats[0].shape[0]
        # NHWC + inner-A order, the anchors' enumeration order
        logits = [l.permute(0, 2, 3, 1).reshape(b, -1) for l in logits_nchw]
        deltas = [d.permute(0, 2, 3, 1).reshape(b, -1, 4) for d in deltas_nchw]
        anchors = multilevel_anchors(
            [f.shape[2:4] for f in feats],
            [FPN_STRIDES[n] for n in c.in_features],
            self.anchor_cfg.sizes, self.anchor_cfg.aspect_ratios,
            self.anchor_cfg.offset, device=feats[0].device,
        )
        losses = {}
        if train and gt is not None:
            losses = self._losses(anchors, logits, deltas, gt, generator)
        topk = c.pre_nms_topk_train if train else c.pre_nms_topk_test
        post = c.post_nms_topk_train if train else c.post_nms_topk_test
        boxes, scores, valid = self._predict_proposals(
            anchors, logits, deltas, image_sizes, topk, post)
        if train:
            # proposals feed ROI sampling only
            boxes, scores = boxes.detach(), scores.detach()
        return RPNOutput(boxes, scores, valid, losses)

    def _losses(self, anchors, logits, deltas, gt: GtInstances, generator):
        """Objectness BCE over the sampled anchors and smooth-L1 on the
        sampled positives, in f32, over the whole batch at once."""
        c = self.cfg
        all_anchors = torch.cat(anchors, dim=0)                   # (N, 4)
        all_logits = torch.cat(logits, dim=1).float()             # (B, N)
        all_deltas = torch.cat(deltas, dim=1).float()             # (B, N, 4)
        b = all_logits.shape[0]
        iou = box_ops.pairwise_iou(gt.boxes, all_anchors)         # (B, G, N)
        midx, mlabel = matcher.match(iou, gt.valid, c.iou_thresholds,
                                     (0, -1, 1), allow_low_quality_matches=True)
        sidx, svalid, spos = sampling.subsample_labels(
            mlabel, c.batch_size_per_image, c.positive_fraction, generator)
        s_logit = torch.gather(all_logits, 1, sidx)
        obj_loss = (L.bce_with_logits(s_logit, spos) * svalid).sum()
        s_gt = torch.gather(midx, 1, sidx)
        tgt = box_ops.get_deltas(
            all_anchors[sidx],
            torch.gather(gt.boxes, 1, s_gt[..., None].expand(-1, -1, 4)),
            c.bbox_reg_weights)
        s_delta = torch.gather(all_deltas, 1, sidx[..., None].expand(-1, -1, 4))
        reg = L.smooth_l1(s_delta, tgt, c.smooth_l1_beta)
        reg_loss = (reg.sum(-1) * spos).sum()
        normalizer = c.batch_size_per_image * b
        return {
            "loss_rpn_cls": c.loss_weight * obj_loss / normalizer,
            "loss_rpn_loc": c.loss_weight * reg_loss / normalizer,
        }

    def _predict_proposals(self, anchors, logits, deltas, image_sizes,
                           topk: int, post: int):
        c = self.cfg
        kmax = max(min(topk, anc.shape[0]) for anc in anchors)
        ninf = -float("inf")
        lvl_boxes, lvl_scores = [], []
        for anc, logit, delta in zip(anchors, logits, deltas):
            k = min(topk, anc.shape[0])
            score, idx = topk_stable(logit, k)                    # (B, k)
            sel_delta = torch.gather(delta, 1, idx[..., None].expand(-1, -1, 4))
            box = box_ops.apply_deltas(sel_delta, anc[idx], c.bbox_reg_weights)
            if k < kmax:
                box = F.pad(box, (0, 0, 0, kmax - k))
                score = F.pad(score, (0, kmax - k), value=ninf)
            lvl_boxes.append(box)
            lvl_scores.append(score)

        # one NMS over the (level, image) grid: levels never suppress each
        # other, and the serial suppression depth is paid once
        nlvl = len(lvl_boxes)
        cap = min(post, kmax)
        stk_b = torch.stack(lvl_boxes)                          # (L, B, kmax, 4)
        stk_s = torch.stack(lvl_scores)                         # (L, B, kmax)
        stk_b = box_ops.clip(stk_b, image_sizes[None])
        ok = box_ops.nonempty(stk_b, threshold=c.min_size)
        stk_s = torch.where(ok, stk_s, torch.full_like(stk_s, ninf))
        with span("u2s.rpn.nms"):
            kidx, kvalid = nms(stk_b, stk_s, c.nms_thresh, cap)  # (L, B, cap)
        kidx = kidx.long()
        kept_b = torch.gather(stk_b, 2, kidx[..., None].expand(-1, -1, -1, 4))
        kept_b = torch.where(kvalid[..., None], kept_b, torch.zeros_like(kept_b))
        kept_s = torch.gather(stk_s, 2, kidx)
        kept_s = torch.where(kvalid, kept_s, torch.full_like(kept_s, ninf))

        b = stk_b.shape[1]
        all_b = kept_b.permute(1, 0, 2, 3).reshape(b, nlvl * cap, 4)
        all_s = kept_s.permute(1, 0, 2).reshape(b, nlvl * cap)
        fs, fi = topk_stable(all_s, post)
        boxes = torch.gather(all_b, 1, fi[..., None].expand(-1, -1, 4))
        # downstream consumers expect f32 scores; the selection above ran in
        # the head dtype
        scores = fs.float()
        valid = scores > ninf
        boxes = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
        return boxes, scores, valid
