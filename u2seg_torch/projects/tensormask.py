"""TensorMask: dense sliding-window instance segmentation (counterpart of
``u2seg_tpu/projects/tensormask.py``; detectron2's ``projects/TensorMask``).

``swap_align2nat`` is the project's SwapAlign2Nat op (arXiv:1903.12174):
given aligned mask windows ``(N, V*U, H, W)`` it swaps the unit lengths of
the window axes (V, U) and the spatial axes (H, W) by ``lambda`` and turns
the aligned representation (a window relative to its own pixel) into the
natural one (a window on the image grid), with quadrilinear interpolation
and ``pad_val`` outside the tensor. Each output element reads 16 taps: two
per axis, with one weight per axis. A spatial tap and a window tap of the
same direction share the output's (V, y) or (U, x) pair, so the op is two
gathers, one per direction, each of four taps. Every intermediate has the
size of the input or the output: the JAX package's einsum order makes a
(N, H, W, V', U') intermediate, 124 GB at p7 of an 800 x 1344 image.

``TensorMask`` is the meta-architecture over FPN features: cls / box / mask
towers, the bipyramid fuse, per-window-size mask predictors, the assignment
rule (containment, scale, centrality, one GT only), focal* / L1 / weighted
BCE losses on a fixed-capacity foreground slot table, and inference (top-k
candidates, class-aware NMS, each detection's natural window resized to a
fixed patch as ``jax.image.resize`` resizes it). NCHW features.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from u2seg_torch.models.fpn import FPN_STRIDES
from u2seg_torch.models.layers import Conv2d
from u2seg_torch.ops.aspp import resize_bilinear
from u2seg_torch.ops.losses import softplus
from u2seg_torch.ops.nms import batched_nms, topk_stable
from u2seg_torch.structures import boxes as box_ops
from u2seg_torch.structures.instances import GtInstances


def _pair_taps(lam: int, n_win: int, n_space: int, n_out: int):
    """The four taps of one direction: output (o, w) for o < n_out, w <
    lam * n_win reads window cell ``(w + 0.5) / lam - 0.5`` and spatial cell
    ``o * lam + w - lam * n_win / 2 + 0.5``, floor and ceil each with its
    linear weight, a tap outside its axis weighted 0. Returns flat indices
    ``win * n_space + space`` (4, n_out * W), weights (4, n_out * W) f32, and
    the in-range weight sum of each axis: window (W,), spatial (W, n_out)."""
    w_out = lam * n_win
    win_c = (np.arange(w_out) + 0.5) / lam - 0.5                           # (W,)
    sp_c = (np.arange(n_out)[:, None] * float(lam) + np.arange(w_out)[None, :]
            - w_out / 2.0 + 0.5)                                           # (O, W)

    def taps(c, size):
        f = np.floor(c).astype(np.int64)
        cl = np.ceil(c).astype(np.int64)
        wc = (c - f).astype(np.float32)
        wf = (1.0 - (c - f)).astype(np.float32)
        out = []
        for i, w in ((f, wf), (cl, wc)):
            ok = (i >= 0) & (i < size)
            out.append((np.clip(i, 0, size - 1), np.where(ok, w, np.float32(0))))
        return out

    win_t = taps(win_c, n_win)
    sp_t = taps(sp_c, n_space)
    idx, wts = [], []
    for si, sw in sp_t:
        for wi, ww in win_t:
            idx.append((wi[None, :] * n_space + si).reshape(-1))
            wts.append((sw * ww[None, :]).reshape(-1))
    win_sum = (win_t[0][1] + win_t[1][1]).astype(np.float32)               # (W,)
    sp_sum = (sp_t[0][1] + sp_t[1][1]).astype(np.float32).T                # (W, O)
    return np.stack(idx), np.stack(wts).astype(np.float32), win_sum, sp_sum


def swap_align2nat(x: torch.Tensor, lambda_val: int, pad_val: float = -6.0) -> torch.Tensor:
    """(N, V*U, H, W) aligned windows -> (N, V'*U', H', W') natural windows,
    V' = lambda * V, H' = ceil(H / lambda) (V == U).

    Output (v, u, y, x) reads input window ((v + 0.5) / l - 0.5, (u + 0.5) /
    l - 0.5) at spatial (y * l + v - V' / 2 + 0.5, x * l + u - U' / 2 + 0.5),
    quadrilinear, ``pad_val`` times the weight that falls outside."""
    n, c, hin, win = x.shape
    vin = math.isqrt(c)
    if vin * vin != c:
        raise ValueError("#channels must be a square number")
    lam = int(lambda_val)
    vout = lam * vin
    hout, wout = -(-hin // lam), -(-win // lam)
    # (y, v) taps over rows; (x, u) taps over columns: small tables, made on
    # the host and moved to the input's device
    iy, wy, sv, sy = (torch.from_numpy(a).to(x.device) for a in _pair_taps(lam, vin, hin, hout))
    ix, wx, su, sx = (torch.from_numpy(a).to(x.device) for a in _pair_taps(lam, vin, win, wout))
    xs = x.float().reshape(n, vin, vin, hin, win)          # (N, v, u, y, x)
    # contract (x, u): (N, v, y, u * W) gathered at columns u * W + x
    cols = xs.permute(0, 1, 3, 2, 4).reshape(n, vin * hin, vin * win)
    t = sum(cols.index_select(2, ix[k]) * wx[k] for k in range(4))     # (N, v * H, Wout * Uout)
    # contract (y, v): rows v * H + y
    out = sum(t.index_select(1, iy[k]) * wy[k][:, None] for k in range(4))
    out = out.reshape(n, hout, vout, wout, vout)           # (N, Y, V, X, U)
    # the in-range weight factorizes per axis
    inside = (sv[:, None, None, None] * su[None, :, None, None]
              * sy[:, None, :, None] * sx[None, :, None, :])
    out = out.permute(0, 2, 4, 1, 3) + pad_val * (1.0 - inside)       # (N, V, U, Y, X)
    return out.reshape(n, vout * vout, hout, wout)


class SwapAlign2Nat(nn.Module):
    """The reference layer's interface."""

    def __init__(self, lambda_val: int, pad_val: float = -6.0):
        super().__init__()
        if lambda_val < 1:
            raise ValueError("lambda_val must be >= 1")
        self.lambda_val = lambda_val
        self.pad_val = pad_val

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swap_align2nat(x, self.lambda_val, self.pad_val)


@dataclasses.dataclass
class TensorMaskConfig:
    """MODEL.TENSOR_MASK defaults (detectron2 TensorMask's config)."""

    num_classes: int = 80
    in_features: Sequence[str] = ("p2", "p3", "p4", "p5", "p6", "p7")
    num_convs: int = 4
    cls_channels: int = 256
    bbox_channels: int = 128
    mask_channels: int = 128
    # base window sizes at the finest level, in units of its stride
    mask_sizes: Sequence[int] = (11, 15)
    focal_alpha: float = 0.3
    focal_gamma: float = 3.0
    bbox_reg_weights: Sequence[float] = (1.5, 1.5, 0.75, 0.75)
    mask_loss_weight: float = 2.0
    mask_pos_weight: float = 1.5
    align_on: bool = True
    bipyramid_on: bool = True
    score_thresh: float = 0.05
    topk_candidates: int = 6000
    nms_thresh: float = 0.5
    max_detections: int = 100
    mask_out_size: int = 28          # fixed box-relative output patch
    max_fg: int = 64                 # foreground slot capacity of the mask loss


def _focal_loss_star(logits, targets, alpha: float, gamma: float):
    """fvcore's sigmoid_focal_loss_star."""
    shifted = gamma * (logits * (2.0 * targets - 1.0))
    loss = -F.logsigmoid(shifted) / gamma
    if alpha >= 0:
        loss = loss * (targets * alpha + (1.0 - targets) * (1.0 - alpha))
    return loss


def tensormask_assign(gt: GtInstances, anchors: torch.Tensor, units: torch.Tensor,
                      min_anchor_size: float, scale_thresh: float = 2.0,
                      spatial_thresh: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The assignment rule over a batch: ``gt`` (B, G) fields, anchors (M, 4)
    -> (matches (B, M), fg (B, M)). An anchor is foreground iff it contains
    its GT, is at most ``scale_thresh`` x the GT's long side (with a floor),
    its centre is within one unit of the GT's, and exactly one GT passes."""
    gb = gt.boxes                                                  # (B, G, 4)
    lt_ok = (anchors[None, None, :, :2] <= gb[:, :, None, :2]).all(-1)
    rb_ok = (anchors[None, None, :, 2:] >= gb[:, :, None, 2:]).all(-1)
    contain = lt_ok & rb_ok                                        # (B, G, M)
    gt_long = torch.maximum(gb[..., 2] - gb[..., 0], gb[..., 3] - gb[..., 1])
    gt_upper = torch.clamp(gt_long * scale_thresh, min=min_anchor_size)
    anc_size = torch.maximum(anchors[:, 2] - anchors[:, 0],
                             anchors[:, 3] - anchors[:, 1]) - units
    scale_ok = gt_upper[..., None] >= anc_size
    gc = (gb[..., :2] + gb[..., 2:]) / 2.0
    ac = (anchors[:, :2] + anchors[:, 2:]) / 2.0
    off = (gc[:, :, None, :] - ac[None, None]) / units[None, None, :, None]
    spatial_ok = torch.sum(off * off, -1) <= spatial_thresh ** 2
    assign = contain & scale_ok & spatial_ok & gt.valid[..., None]
    n_match = assign.sum(1)
    matches = torch.argmax(assign.to(torch.uint8), dim=1).to(torch.int32)
    return matches, n_match == 1


def _crop_gt_mask(gt_patch: torch.Tensor, gt_box: torch.Tensor, anchor_box: torch.Tensor,
                  out_size: int) -> torch.Tensor:
    """Each GT's box-relative mask patch (F, P, P) rasterised over its anchor
    window (F, out, out): bilinear (align_corners=False, 0 outside), then
    thresholded at 0.5."""
    p = gt_patch.shape[1]
    dev = gt_patch.device
    r = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) / out_size
    ys = anchor_box[:, 1:2] + r * (anchor_box[:, 3:4] - anchor_box[:, 1:2])
    xs = anchor_box[:, 0:1] + r * (anchor_box[:, 2:3] - anchor_box[:, 0:1])
    gy = (ys - gt_box[:, 1:2]) / torch.clamp(gt_box[:, 3:4] - gt_box[:, 1:2], min=1e-6)
    gx = (xs - gt_box[:, 0:1]) / torch.clamp(gt_box[:, 2:3] - gt_box[:, 0:1], min=1e-6)
    py = gy * p - 0.5
    px = gx * p - 0.5
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    fy = (py - y0)[:, :, None]
    fx = (px - x0)[:, None, :]
    rows = torch.arange(gt_patch.shape[0], device=dev)[:, None, None]

    def tap(yi, xi):
        oky = ((yi >= 0) & (yi < p))[:, :, None]
        okx = ((xi >= 0) & (xi < p))[:, None, :]
        v = gt_patch[rows, torch.clamp(yi, 0, p - 1)[:, :, None],
                     torch.clamp(xi, 0, p - 1)[:, None, :]]
        return v * oky * okx

    y0i, x0i = y0.long(), x0.long()
    val = (tap(y0i, x0i) * (1 - fy) * (1 - fx)
           + tap(y0i, x0i + 1) * (1 - fy) * fx
           + tap(y0i + 1, x0i) * fy * (1 - fx)
           + tap(y0i + 1, x0i + 1) * fy * fx)
    return (val >= 0.5).float()


class TensorMaskHead(nn.Module):
    """cls / box / mask towers (``{cls,bbox,mask}_subnet{i}``),
    ``cls_score``, ``bbox_pred``, the bipyramid ``mask_fuse`` and one
    ``mask_pred_{m:02d}`` per window size, then SwapAlign2Nat. Every conv
    starts at normal(0.01), the classifier's bias at the 0.01 prior."""

    prior_prob = 0.01

    def __init__(self, cfg: TensorMaskConfig, in_channels: int):
        super().__init__()
        self.cfg = cfg
        c = cfg
        a = len(c.mask_sizes)
        for name, ch in (("cls_subnet", c.cls_channels), ("bbox_subnet", c.bbox_channels),
                         ("mask_subnet", c.mask_channels)):
            cin = in_channels
            for i in range(c.num_convs):
                self.add_module(f"{name}{i}", Conv2d(cin, ch, 3, padding=1))
                cin = ch
        cls_in = c.cls_channels if c.num_convs else in_channels
        box_in = c.bbox_channels if c.num_convs else in_channels
        mask_in = c.mask_channels if c.num_convs else in_channels
        self.cls_score = Conv2d(cls_in, a * c.num_classes, 3, padding=1)
        self.bbox_pred = Conv2d(box_in, a * 4, 3, padding=1)
        if c.bipyramid_on:
            self.mask_fuse = Conv2d(mask_in, c.mask_channels, 3, padding=1)
            mask_in = c.mask_channels
        for m in c.mask_sizes:
            self.add_module(f"mask_pred_{m:02d}", Conv2d(mask_in, m * m, 1))

    def _tower(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.cfg.num_convs):
            x = F.relu(getattr(self, f"{name}{i}")(x))
        return x

    def forward(self, features: Sequence[torch.Tensor]):
        """-> per-level logits (B, A*K, H, W), deltas (B, A*4, H, W), and per
        level and window size the (natural) mask windows (B, size^2, H', W')."""
        c = self.cfg
        logits = [self.cls_score(self._tower("cls_subnet", f)).float() for f in features]
        deltas = [self.bbox_pred(self._tower("bbox_subnet", f)).float() for f in features]
        mask_feats = [self._tower("mask_subnet", f) for f in features]
        if c.bipyramid_on:
            # every level's mask features on the finest grid, plus the finest
            h0, w0 = mask_feats[0].shape[2:]
            fused = []
            for lvl, mf in enumerate(mask_feats):
                if lvl > 0:
                    lam = 2 ** lvl
                    mf = resize_bilinear(mf, (mf.shape[2] * lam, mf.shape[3] * lam))[:, :, :h0, :w0]
                fused.append(F.relu(self.mask_fuse(mf + mask_feats[0])))
            mask_feats = fused
        masks = []
        for lvl, mf in enumerate(mask_feats):
            lam = 2 ** lvl if c.bipyramid_on else 1
            row = []
            for m in c.mask_sizes:
                pm = getattr(self, f"mask_pred_{m:02d}")(mf).float()
                if c.align_on:
                    pm = swap_align2nat(pm, lam)
                row.append(pm)
            masks.append(row)
        return logits, deltas, masks


class TensorMask(nn.Module):
    """TensorMask over FPN features: ``forward(features, image_sizes)`` ->
    the inference dict; with ``train=True`` and ``gt`` the loss dict."""

    def __init__(self, cfg: TensorMaskConfig, in_channels: int,
                 strides: Optional[Dict[str, int]] = None):
        super().__init__()
        self.cfg = cfg
        self.strides = dict(strides or FPN_STRIDES)
        self.head = TensorMaskHead(cfg, in_channels)

    def _anchor_table(self, shapes, dev):
        """Anchors (M, 4), units (M,) and provenance (M, 4: level, anchor,
        y, x), ordered (level, anchor, cell)."""
        c = self.cfg
        boxes, units, prov = [], [], []
        for lvl, f in enumerate(c.in_features):
            s = self.strides[f]
            h, w = shapes[lvl]
            ys = (np.arange(h) + 0.5) * s
            xs = (np.arange(w) + 0.5) * s
            for a, m in enumerate(c.mask_sizes):
                side = m * s
                cy, cx = np.meshgrid(ys, xs, indexing="ij")
                b = np.stack([cx - side / 2, cy - side / 2, cx + side / 2, cy + side / 2], -1)
                boxes.append(b.reshape(-1, 4))
                units.append(np.full(h * w, s, np.float32))
                lin = np.arange(h * w)
                prov.append(np.stack([np.full(h * w, lvl), np.full(h * w, a),
                                      lin // w, lin % w], -1))
        return (torch.from_numpy(np.concatenate(boxes).astype(np.float32)).to(dev),
                torch.from_numpy(np.concatenate(units)).to(dev),
                torch.from_numpy(np.concatenate(prov).astype(np.int64)).to(dev))

    def forward(self, features: Dict[str, torch.Tensor], image_sizes: torch.Tensor,
                gt: Optional[GtInstances] = None, train: bool = False):
        c = self.cfg
        feats = [features[f] for f in c.in_features]
        logits_l, deltas_l, masks_l = self.head(feats)
        anchors, units, prov = self._anchor_table([f.shape[2:] for f in feats], feats[0].device)
        b, k, a = feats[0].shape[0], c.num_classes, len(c.mask_sizes)

        def flat(x, d):
            # (B, A*d, H, W) -> (B, A*H*W, d), anchor-major within a level
            return (x.reshape(b, a, d, -1).permute(0, 1, 3, 2).reshape(b, -1, d))

        logits = torch.cat([flat(x, k) for x in logits_l], 1)
        deltas = torch.cat([flat(x, 4) for x in deltas_l], 1)
        if train:
            if gt is None:
                raise ValueError("training needs gt instances")
            return self._losses(logits, deltas, masks_l, anchors, units, prov, gt)
        return self._inference(logits, deltas, masks_l, anchors, prov, image_sizes)

    def _window_size(self, lvl: int, m: int) -> int:
        c = self.cfg
        return m * (2 ** lvl if c.bipyramid_on else 1) if c.align_on else m

    def _losses(self, logits, deltas, masks_l, anchors, units, prov, gt: GtInstances):
        c = self.cfg
        min_anchor = min(c.mask_sizes) * min(self.strides[f] for f in c.in_features)
        matches, fg = tensormask_assign(gt, anchors, units, float(min_anchor))
        num_fg = torch.clamp(fg.sum().float(), min=1.0)

        # focal* classification over every anchor
        cls = torch.gather(gt.classes.long(), 1, matches.long())
        cls = torch.where(fg, cls, torch.full_like(cls, -1))
        tgt = F.one_hot(torch.clamp(cls, min=0), c.num_classes).float() * (cls >= 0)[..., None]
        loss_cls = torch.sum(_focal_loss_star(logits, tgt, c.focal_alpha, c.focal_gamma)) / num_fg

        # box regression: L1 on the foreground
        mb = torch.gather(gt.boxes, 1, matches.long()[..., None].expand(-1, -1, 4))
        t = box_ops.get_deltas(anchors.expand(mb.shape), mb, tuple(c.bbox_reg_weights))
        loss_box = torch.sum(torch.abs(deltas - t) * fg[..., None]) / num_fg

        # mask BCE on a fixed-capacity slot table of foreground anchors
        flat_fg = fg.reshape(-1)
        score = flat_fg.float() * 1e6 - torch.arange(flat_fg.numel(), dtype=torch.float32,
                                                      device=fg.device)
        _, slot = topk_stable(score, min(c.max_fg, flat_fg.numel()))
        m_tot = fg.shape[1]
        slot_img = torch.div(slot, m_tot, rounding_mode="floor")
        slot_anchor = slot % m_tot
        slot_fg = flat_fg[slot]
        slot_gt = matches.reshape(-1)[slot].long()
        slot_prov = prov[slot_anchor]
        slot_box = anchors[slot_anchor]
        gt_boxes_s = gt.boxes[slot_img, slot_gt]
        gt_patch_s = gt.masks[slot_img, slot_gt].float()

        loss_mask = 0.0
        for lvl in range(len(c.in_features)):
            for ai, m in enumerate(c.mask_sizes):
                size = self._window_size(lvl, m)
                pm = masks_l[lvl][ai]                                 # (B, size^2, H', W')
                hh, ww = pm.shape[2], pm.shape[3]
                lin = torch.clamp(slot_img * hh * ww + slot_prov[:, 2] * ww + slot_prov[:, 3],
                                  0, pm.shape[0] * hh * ww - 1)
                img, cell = torch.div(lin, hh * ww, rounding_mode="floor"), lin % (hh * ww)
                pred = pm[img, :, torch.div(cell, ww, rounding_mode="floor"), cell % ww]
                gt_win = _crop_gt_mask(gt_patch_s, gt_boxes_s, slot_box, size).reshape(-1, size * size)
                sel = slot_fg & (slot_prov[:, 0] == lvl) & (slot_prov[:, 1] == ai)
                per = (c.mask_pos_weight * gt_win * softplus(-pred)
                       + (1.0 - gt_win) * softplus(pred))
                loss_mask = loss_mask + torch.sum(per * sel[:, None]) * (
                    c.mask_loss_weight / (size * size))
        loss_mask = loss_mask / num_fg
        return {"loss_cls": loss_cls, "loss_box_reg": loss_box, "loss_mask": loss_mask}

    def _inference(self, logits, deltas, masks_l, anchors, prov, image_sizes):
        c = self.cfg
        b, m_tot, k = logits.shape
        scores = torch.sigmoid(logits).reshape(b, -1)
        scores = torch.where(scores > c.score_thresh, scores, torch.zeros_like(scores))
        top_s, top_i = topk_stable(scores, min(c.topk_candidates, scores.shape[1]))
        a_i = torch.div(top_i, k, rounding_mode="floor")
        cls_i = (top_i % k).to(torch.int32)
        d = torch.gather(deltas, 1, a_i[..., None].expand(-1, -1, 4))
        boxes = box_ops.apply_deltas(d, anchors[a_i], tuple(c.bbox_reg_weights))
        boxes = box_ops.clip(boxes, image_sizes)
        nms_scores = torch.where(top_s > 0.0, top_s, torch.full_like(top_s, -float("inf")))
        keep_i, keep_valid = batched_nms(boxes, nms_scores, cls_i, c.nms_thresh,
                                         c.max_detections)
        keep = keep_i.long()
        scores = torch.gather(top_s, 1, keep) * keep_valid
        boxes = torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 4))
        classes = torch.gather(cls_i, 1, keep)
        anchor_ids = torch.gather(a_i, 1, keep)
        valid = scores > 0.0

        # each detection's natural window, resized to the fixed patch
        r = c.mask_out_size
        det = boxes.shape[1]
        patches = torch.zeros((b, det, r, r), dtype=torch.float32, device=boxes.device)
        det_prov = prov[anchor_ids]                                   # (B, D, 4)
        img = torch.arange(b, device=boxes.device)[:, None].expand(-1, det).reshape(-1)
        for lvl in range(len(c.in_features)):
            for ai, m in enumerate(c.mask_sizes):
                size = self._window_size(lvl, m)
                pm = masks_l[lvl][ai]
                hh, ww = pm.shape[2], pm.shape[3]
                yy = torch.clamp(det_prov[..., 2], max=hh - 1).reshape(-1)
                xx = torch.clamp(det_prov[..., 3], max=ww - 1).reshape(-1)
                win = pm[img, :, yy, xx].reshape(b * det, 1, size, size)
                win = resize_bilinear(win, (r, r)).reshape(b, det, r, r)
                sel = (det_prov[..., 0] == lvl) & (det_prov[..., 1] == ai)
                patches = torch.where(sel[..., None, None], win, patches)
        return {"boxes": boxes, "scores": scores, "classes": classes, "valid": valid,
                "mask_patches": torch.sigmoid(patches), "mask_src_boxes": anchors[anchor_ids]}
