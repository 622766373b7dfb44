"""DensePose, chart-based: dense human surface coordinates (counterpart of
``u2seg_tpu/projects/densepose.py``; the chart pipeline of detectron2's
``projects/DensePose``).

The v1-convX ROI head (``body_conv_fcn1..N``), the chart predictor (coarse
segmentation, 24 + 1 fine patches, per-patch U and V, optional UV
confidences; each a stride-2 deconv then a bilinear 2x as
``jax.image.resize`` scales), the chart losses at annotated points (points
are GT-box-relative in the data and re-expressed in each proposal's frame)
and IUV inference.

NCHW maps: the predictor's outputs are ``(R, C, S, S)``; annotated points
are ``(R, P, ...)`` arrays masked by their validity. ``DensePoseHeads`` pools
28 x 28 on p2-p5 with the gather pooler ``ops.roi_align.multilevel_roi_align``
(as the JAX package does): no kernel of the port lies on this path.

The predictor's deconvs are ``ConvTranspose2d(k=4, stride=2, padding=1)``:
flax's ``ConvTranspose`` with explicit padding 2 on each side and an
unflipped kernel is the same map with the kernel flipped and its in / out
axes swapped (``weights.projects_from_jax`` does that).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from u2seg_torch.models.layers import Conv2d, ConvTranspose2d
from u2seg_torch.ops.aspp import resize_bilinear
from u2seg_torch.ops.losses import softplus
from u2seg_torch.ops.roi_align import multilevel_roi_align


@dataclasses.dataclass
class DensePoseConfig:
    """ROI_DENSEPOSE_HEAD defaults (detectron2 DensePose's config)."""

    num_stacked_convs: int = 8
    conv_head_dim: int = 512
    conv_head_kernel: int = 3
    deconv_kernel: int = 4
    num_coarse_segm_channels: int = 2     # fg/bg (or 15 body parts)
    num_patches: int = 24                 # fine charts (+1 background)
    up_scale: int = 2                     # extra bilinear upscale
    w_points: float = 0.1
    w_part: float = 1.0
    w_segm: float = 2.0
    # UV confidence: "" plain smooth-L1, "iid_iso" a sigma_2 head,
    # "indep_aniso" sigma_2 + kappa_u + kappa_v heads
    uv_confidence: str = ""
    uv_confidence_epsilon: float = 0.01


class DensePoseV1ConvXHead(nn.Module):
    """``num_stacked_convs`` 3x3 convs with relu (``body_conv_fcn{i}``)."""

    def __init__(self, cfg: DensePoseConfig, in_channels: int):
        super().__init__()
        self.num = cfg.num_stacked_convs
        k = cfg.conv_head_kernel
        ch = in_channels
        for i in range(self.num):
            self.add_module(f"body_conv_fcn{i + 1}",
                            Conv2d(ch, cfg.conv_head_dim, k, padding=k // 2))
            ch = cfg.conv_head_dim
        self.out_channels = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num):
            x = F.relu(getattr(self, f"body_conv_fcn{i + 1}")(x))
        return x


def deconv_upscaled(deconv: nn.Module, x: torch.Tensor, up_scale: int) -> torch.Tensor:
    """``deconv(x)`` resized ``up_scale`` x as ``jax.image.resize`` bilinear
    resizes, in f32."""
    y = deconv(x)
    if up_scale > 1:
        y = resize_bilinear(y, (y.shape[2] * up_scale, y.shape[3] * up_scale))
    return y.float()


def chart_deconv(in_channels: int, out_channels: int, k: int) -> ConvTranspose2d:
    """The predictors' stride-2 deconv, which doubles the side."""
    return ConvTranspose2d(in_channels, out_channels, k, stride=2, padding=k // 2 - 1)


class DensePoseChartPredictor(nn.Module):
    """The deconv heads (``ann_index_lowres``, ``index_uv_lowres``,
    ``u_lowres``, ``v_lowres``, and the confidence heads), each upsampled
    2x by the deconv and ``up_scale`` x bilinearly."""

    HEADS = (("coarse_segm", "ann_index_lowres"), ("fine_segm", "index_uv_lowres"),
             ("u", "u_lowres"), ("v", "v_lowres"))

    def __init__(self, cfg: DensePoseConfig, in_channels: int):
        super().__init__()
        self.cfg = cfg
        k, n = cfg.deconv_kernel, cfg.num_patches + 1
        self.heads = [(key, name) for key, name in self.HEADS]
        if cfg.uv_confidence:
            self.heads.append(("sigma_2", "sigma_2_lowres"))
            if cfg.uv_confidence == "indep_aniso":
                self.heads += [("kappa_u", "kappa_u_lowres"), ("kappa_v", "kappa_v_lowres")]
        for key, name in self.heads:
            out = cfg.num_coarse_segm_channels if key == "coarse_segm" else n
            self.add_module(name, chart_deconv(in_channels, out, k))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {key: deconv_upscaled(getattr(self, name), x, self.cfg.up_scale)
                for key, name in self.heads}


@dataclasses.dataclass
class DensePosePoints:
    """Annotated points per ROI, in the proposal box's [0, 1]^2 frame."""

    coords: torch.Tensor       # (R, P, 2) (x, y)
    fine_labels: torch.Tensor  # (R, P) int patch index 1..24 (0 = bg)
    u: torch.Tensor            # (R, P) f32
    v: torch.Tensor            # (R, P) f32
    valid: torch.Tensor        # (R, P) bool


def _smooth_l1(x: torch.Tensor) -> torch.Tensor:
    a = torch.abs(x)
    return torch.where(a < 1.0, 0.5 * x * x, a - 0.5)


def chart_point_sample(maps: torch.Tensor, coords01: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with the chart losses' grid: index = coord * S,
    lower corner floored and clamped to [0, S-1], upper = lower + 1 clamped,
    the weight measured after clamping (index 0 at the box's left edge, not
    at the first pixel centre). maps (R, C, S, S), coords (R, P, 2) ->
    (R, P, C)."""
    r, c, s, _ = maps.shape

    def axis_idx(v):
        vg = v * s
        lo = torch.clamp(torch.floor(vg).long(), 0, s - 1)
        hi = torch.clamp(lo + 1, max=s - 1)
        w = torch.minimum(hi.to(vg.dtype), vg) - lo
        return lo, hi, w

    xlo, xhi, xw = axis_idx(coords01[..., 0])
    ylo, yhi, yw = axis_idx(coords01[..., 1])
    f = maps.permute(0, 2, 3, 1).reshape(r, s * s, c)

    def at(i):
        return torch.gather(f, 1, i[..., None].expand(-1, -1, c))

    v00, v01 = at(ylo * s + xlo), at(ylo * s + xhi)
    v10, v11 = at(yhi * s + xlo), at(yhi * s + xhi)
    top = v00 + (v01 - v00) * xw[..., None]
    bot = v10 + (v11 - v10) * xw[..., None]
    return top + (bot - top) * yw[..., None]


def remap_points_to_proposals(dp_xy: torch.Tensor, gt_boxes: torch.Tensor,
                              prop_boxes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """GT-box-relative points (R, P, 2) -> proposal-box-relative [0, 1]
    coordinates and whether each lies inside the proposal (``0 <= c < 1``)."""
    g0 = gt_boxes[:, None, :2]
    gsz = torch.clamp(gt_boxes[:, None, 2:] - g0, min=1e-6)
    p0 = prop_boxes[:, None, :2]
    psz = torch.clamp(prop_boxes[:, None, 2:] - p0, min=1e-6)
    v = g0 + dp_xy * gsz
    coords01 = (v - p0) / psz
    inside = ((coords01 >= 0.0) & (coords01 < 1.0)).all(dim=-1)
    return coords01, inside


def resample_coarse_segm_gt(dp_segm: torch.Tensor, gt_boxes: torch.Tensor,
                            prop_boxes: torch.Tensor, out_size: int,
                            binarize: bool = True) -> torch.Tensor:
    """Nearest-resample the GT part raster (R, Sg, Sg) into each proposal's
    S x S grid: output grid lines at j / S, source index ``round(xn * (Sg -
    1))`` (align_corners=True, half to even), 0 outside; binarised for the
    2-channel coarse head."""
    r, sg, _ = dp_segm.shape
    s = out_size
    grid = torch.arange(s, dtype=torch.float32, device=dp_segm.device) / s
    p0 = prop_boxes[:, :2]
    psz = prop_boxes[:, 2:] - p0
    g0 = gt_boxes[:, :2]
    gsz = torch.clamp(gt_boxes[:, 2:] - g0, min=1e-6)
    x = (p0[:, :1] + grid[None, :] * psz[:, :1] - g0[:, :1]) / gsz[:, :1]
    y = (p0[:, 1:] + grid[None, :] * psz[:, 1:] - g0[:, 1:]) / gsz[:, 1:]
    xi = torch.round(x * (sg - 1)).long()
    yi = torch.round(y * (sg - 1)).long()
    x_ok = (xi >= 0) & (xi <= sg - 1)
    y_ok = (yi >= 0) & (yi <= sg - 1)
    xi = torch.clamp(xi, 0, sg - 1)
    yi = torch.clamp(yi, 0, sg - 1)
    rows = torch.arange(r, device=dp_segm.device)[:, None, None]
    out = dp_segm[rows, yi[:, :, None], xi[:, None, :]].long()
    out = torch.where(y_ok[:, :, None] & x_ok[:, None, :], out, torch.zeros_like(out))
    if binarize:
        out = (out > 0).long()
    return out


def _take_channel(x: torch.Tensor, ch: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, ch[..., None])[..., 0]


def densepose_chart_losses(outputs: Dict[str, torch.Tensor], points: DensePosePoints,
                           coarse_gt: torch.Tensor, roi_valid: torch.Tensor,
                           cfg: DensePoseConfig) -> Dict[str, torch.Tensor]:
    """The chart losses: smooth-L1 (or the Gaussian NLL with confidences) on
    U / V at annotated foreground points (sum, ``w_points``), CE over the
    fine patches at annotated points (mean, ``w_part``) and CE of the coarse
    segmentation over every pixel of the valid ROIs (mean, ``w_segm``)."""
    live = points.valid & roi_valid[:, None]
    n_pts = torch.clamp(live.sum().float(), min=1.0)
    fine_at = chart_point_sample(outputs["fine_segm"], points.coords)
    u_at = chart_point_sample(outputs["u"], points.coords)
    v_at = chart_point_sample(outputs["v"], points.coords)
    reg_live = live & (points.fine_labels > 0)
    ch = torch.clamp(points.fine_labels.long(), 0, cfg.num_patches)
    u_est = _take_channel(u_at, ch)
    v_est = _take_channel(v_at, ch)
    out: Dict[str, torch.Tensor] = {}
    if cfg.uv_confidence:
        s_est = _take_channel(chart_point_sample(outputs["sigma_2"], points.coords), ch)
        sigma2 = softplus(s_est) + cfg.uv_confidence_epsilon
        du = u_est - points.u
        dv = v_est - points.v
        delta2 = du * du + dv * dv
        log2pi = math.log(2.0 * math.pi)
        if cfg.uv_confidence == "iid_iso":
            nll = 0.5 * (log2pi + 2.0 * torch.log(sigma2) + delta2 / sigma2)
        elif cfg.uv_confidence == "indep_aniso":
            ku = _take_channel(chart_point_sample(outputs["kappa_u"], points.coords), ch)
            kv = _take_channel(chart_point_sample(outputs["kappa_v"], points.coords), ch)
            r2 = ku * ku + kv * kv
            delta_r = du * ku + dv * kv
            denom2 = sigma2 * (sigma2 + r2)
            nll = 0.5 * (log2pi + torch.log(denom2) + delta2 / sigma2
                         - (delta_r * delta_r) / denom2)
        else:
            raise ValueError(cfg.uv_confidence)
        out["loss_densepose_UV"] = torch.sum(nll * reg_live) * cfg.w_points
    else:
        out["loss_densepose_U"] = torch.sum(_smooth_l1(u_est - points.u) * reg_live) * cfg.w_points
        out["loss_densepose_V"] = torch.sum(_smooth_l1(v_est - points.v) * reg_live) * cfg.w_points
    ce = -_take_channel(torch.log_softmax(fine_at, dim=-1), ch)
    out["loss_densepose_I"] = torch.sum(ce * live) / n_pts * cfg.w_part
    segm = outputs["coarse_segm"]
    k = segm.shape[1]
    gt = torch.clamp(coarse_gt.long(), 0, k - 1)
    ce_s = -torch.gather(torch.log_softmax(segm, dim=1), 1, gt[:, None])[:, 0]
    denom = torch.clamp(roi_valid.sum().float() * ce_s.shape[1] * ce_s.shape[2], min=1.0)
    out["loss_densepose_S"] = torch.sum(ce_s * roi_valid[:, None, None]) / denom * cfg.w_segm
    return out


def densepose_chart_inference(outputs: Dict[str, torch.Tensor]
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Predictor outputs -> per-pixel (I, U, V) maps (R, S, S): I the argmax
    fine patch gated by the coarse foreground, U / V read from that channel
    and clipped to [0, 1] (0 on background)."""
    fg = torch.argmax(outputs["coarse_segm"], dim=1) > 0
    i_map = torch.argmax(outputs["fine_segm"], dim=1)
    i_map = torch.where(fg, i_map, torch.zeros_like(i_map))
    u = torch.gather(outputs["u"], 1, i_map[:, None])[:, 0]
    v = torch.gather(outputs["v"], 1, i_map[:, None])[:, 0]
    u = torch.clamp(u, 0.0, 1.0) * (i_map > 0)
    v = torch.clamp(v, 0.0, 1.0) * (i_map > 0)
    return i_map.to(torch.int32), u, v


class DensePoseROIHead(nn.Module):
    """``head`` + ``predictor`` over pooled ROI features (R, C, S, S); the
    output maps are S * 2 * up_scale square."""

    def __init__(self, cfg: DensePoseConfig, in_channels: int):
        super().__init__()
        self.head = DensePoseV1ConvXHead(cfg, in_channels)
        self.predictor = DensePoseChartPredictor(cfg, self.head.out_channels)

    def forward(self, pooled: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.predictor(self.head(pooled))


def pool_fpn_rois(features: Dict[str, torch.Tensor], boxes: torch.Tensor,
                  resolution: int, strides: Tuple[int, ...]) -> torch.Tensor:
    """The gather pooler over p2.. NCHW maps for (B, R, 4) boxes -> f32
    (B*R, C, S, S)."""
    b, r, _ = boxes.shape
    bidx = torch.arange(b, dtype=torch.int32, device=boxes.device).repeat_interleave(r)
    feats = [features[f"p{i + 2}"].permute(0, 2, 3, 1) for i in range(len(strides))]
    pooled = multilevel_roi_align(feats, boxes.reshape(-1, 4), bidx, resolution, strides)
    return pooled.permute(0, 3, 1, 2)


class DensePoseHeads(nn.Module):
    """Pool (28 x 28 on p2-p5) + head + predictor over FPN features, with
    the training losses and inference: the densepose branch of
    detectron2's ``DensePoseROIHeads``, composed with any R-CNN of the
    port. The module ``densepose`` holds head and predictor.

    Train: fg ROI boxes and the matched GT arrays per ROI (the
    ``densepose_data.pack_densepose_gt`` layout gathered by
    ``gather_densepose_gt_for_rois``). Inference: detection boxes -> the
    chart outputs per ROI (B, R, C, S, S)."""

    def __init__(self, cfg: DensePoseConfig, in_channels: int, pooler_resolution: int = 28,
                 strides: Tuple[int, ...] = (4, 8, 16, 32), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.pooler_resolution = pooler_resolution
        self.strides = tuple(strides)
        self.dtype = dtype
        self.densepose = DensePoseROIHead(cfg, in_channels)

    def forward(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor,
                train: bool = False, gt: Optional[Dict[str, torch.Tensor]] = None,
                roi_live: Optional[torch.Tensor] = None):
        pooled = pool_fpn_rois(features, boxes, self.pooler_resolution, self.strides)
        outputs = self.densepose(pooled.to(self.dtype))
        if not train:
            b, r, _ = boxes.shape
            return {k: v.reshape(b, r, *v.shape[1:]) for k, v in outputs.items()}
        if gt is None or roi_live is None:
            raise ValueError("training needs gt and roi_live")

        def flat(x):
            return x.reshape(-1, *x.shape[2:])

        return densepose_losses_from_raw(
            outputs, flat(boxes), flat(roi_live), flat(gt["gt_boxes"]), flat(gt["dp_xy"]),
            flat(gt["dp_i"]), flat(gt["dp_u"]), flat(gt["dp_v"]),
            flat(gt["dp_point_valid"]), flat(gt["dp_segm"]), self.cfg)


def gather_densepose_gt_for_rois(gt: Dict[str, torch.Tensor], gt_boxes: torch.Tensor,
                                 roi_gt_idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-image packed GT (B, G, ...) -> per-ROI arrays (B, R, ...) at each
    ROI's matched GT slot."""
    def take(x):
        idx = roi_gt_idx.long()
        idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
            idx.shape + x.shape[2:])
        return torch.gather(x, 1, idx)

    return {"gt_boxes": take(gt_boxes), "dp_xy": take(gt["dp_xy"]), "dp_i": take(gt["dp_i"]),
            "dp_u": take(gt["dp_u"]), "dp_v": take(gt["dp_v"]),
            "dp_point_valid": take(gt["dp_point_valid"]),
            "dp_segm": take(gt["dp_segm"].long())}


def select_densepose_rois(is_fg: torch.Tensor, gt_idx: torch.Tensor, dp_valid: torch.Tensor,
                          capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``capacity`` foreground proposals per image whose matched GT
    carries densepose data, wanted ones first in their order (a stable
    sort) -> (indices (B, cap), live (B, cap))."""
    want = is_fg & torch.gather(dp_valid, 1, gt_idx.long())
    order = torch.argsort((~want).to(torch.int8), dim=1, stable=True)
    idx = order[:, :capacity]
    return idx.to(torch.int32), torch.gather(want, 1, idx)


def densepose_losses_from_raw(outputs: Dict[str, torch.Tensor], roi_boxes: torch.Tensor,
                              roi_live: torch.Tensor, gt_boxes: torch.Tensor,
                              dp_xy: torch.Tensor, dp_i: torch.Tensor, dp_u: torch.Tensor,
                              dp_v: torch.Tensor, dp_point_valid: torch.Tensor,
                              dp_segm: torch.Tensor, cfg: DensePoseConfig
                              ) -> Dict[str, torch.Tensor]:
    """Chart losses from GT-box-relative annotations: the points re-expressed
    in each proposal's frame (those outside it dropped), the part raster
    nearest-resampled to the head's grid, then ``densepose_chart_losses``."""
    s = outputs["coarse_segm"].shape[2]
    coords01, inside = remap_points_to_proposals(dp_xy, gt_boxes, roi_boxes)
    points = DensePosePoints(coords=torch.clamp(coords01, 0.0, 1.0), fine_labels=dp_i,
                             u=dp_u, v=dp_v, valid=dp_point_valid.bool() & inside)
    coarse_gt = resample_coarse_segm_gt(dp_segm, gt_boxes, roi_boxes, s,
                                        binarize=cfg.num_coarse_segm_channels == 2)
    return densepose_chart_losses(outputs, points, coarse_gt, roi_live.bool(), cfg)


def point_iuv_errors(outputs: Dict[str, torch.Tensor], points: DensePosePoints
                     ) -> Dict[str, torch.Tensor]:
    """Point-level diagnostics: I accuracy and mean |dU|, |dV| at the
    annotated foreground points."""
    fine_at = chart_point_sample(outputs["fine_segm"], points.coords)
    i_pred = torch.argmax(fine_at, dim=-1)
    live = points.valid & (points.fine_labels > 0)
    n = torch.clamp(live.sum().float(), min=1.0)
    acc = torch.sum((i_pred == points.fine_labels) * live) / n
    ch = torch.clamp(points.fine_labels.long(), 0, outputs["u"].shape[1] - 1)
    u_at = _take_channel(chart_point_sample(outputs["u"], points.coords), ch)
    v_at = _take_channel(chart_point_sample(outputs["v"], points.coords), ch)
    return {"i_accuracy": acc, "u_mae": torch.sum(torch.abs(u_at - points.u) * live) / n,
            "v_mae": torch.sum(torch.abs(v_at - points.v) * live) / n}
