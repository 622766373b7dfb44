"""PointRend: point-sampled mask refinement (counterpart of
``u2seg_tpu/projects/pointrend.py``; detectron2's ``projects/PointRend``).

Uncertainty-based point selection, a point head (an MLP over fine features
and the coarse logit at each point) and the subdivision inference that
re-predicts the most uncertain points of an upsampled mask.

Every function works over a leading ROI axis (the JAX package maps its
per-ROI functions with ``jax.vmap``): fine features are NCHW ``(N, C, H,
W)``, coarse logits ``(N, M, M)``, points ``(N, P, 2)`` as (x, y) in [0,
1]. Sampled point features come out as rows, ``(N, P, C)``. Random draws
come from a ``torch.Generator``, or are given (``draws``): the rest of the
computation is then the JAX package's, number for number.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from u2seg_torch.models.layers import Linear
from u2seg_torch.ops.aspp import resize_bilinear
from u2seg_torch.ops.losses import bce_with_logits
from u2seg_torch.ops.nms import topk_stable


def point_sample(feat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``feat`` (N, C, H, W) at ``points`` (N, P, 2) in
    [0, 1] -> (N, P, C): ``grid_sample`` with align_corners=False, a tap
    outside the map contributing 0 (not clamped)."""
    n, c, h, w = feat.shape
    x = points[..., 0] * w - 0.5
    y = points[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    flat = feat.permute(0, 2, 3, 1).reshape(n, h * w, c)
    out = 0.0
    for dy, wy in ((0, 1 - (y - y0)), (1, y - y0)):
        for dx, wx in ((0, 1 - (x - x0)), (1, x - x0)):
            yy = y0 + dy
            xx = x0 + dx
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            lin = (torch.clamp(yy, 0, h - 1).long() * w
                   + torch.clamp(xx, 0, w - 1).long())
            taps = torch.gather(flat, 1, lin[..., None].expand(-1, -1, c))
            out = out + taps * (wy * wx * inside)[..., None]
    return out


def calculate_uncertainty(logits: torch.Tensor) -> torch.Tensor:
    """-|logit| of binary masks: most uncertain near 0."""
    return -torch.abs(logits)


def uncertain_point_draws(n: int, num_points: int, oversample_ratio: float = 3.0,
                          importance_sample_ratio: float = 0.75,
                          generator: Optional[torch.Generator] = None,
                          device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The random part of ``sample_uncertain_points``: (N, P * ratio, 2)
    candidates and (N, P - important, 2) random fill, uniform in [0, 1)."""
    n_over = int(num_points * oversample_ratio)
    n_imp = int(num_points * importance_sample_ratio)
    over = torch.rand((n, n_over, 2), generator=generator, device=device)
    rand = torch.rand((n, num_points - n_imp, 2), generator=generator, device=device)
    return over, rand


def sample_uncertain_points(
    coarse_logits: torch.Tensor,          # (N, M, M)
    num_points: int,
    oversample_ratio: float = 3.0,
    importance_sample_ratio: float = 0.75,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Training-time points: oversample uniform candidates, keep the most
    uncertain ``importance_sample_ratio`` of ``num_points`` (ties: the
    lower index first), fill with uniform points -> (N, num_points, 2)."""
    if draws is None:
        draws = uncertain_point_draws(coarse_logits.shape[0], num_points, oversample_ratio,
                                      importance_sample_ratio, generator,
                                      coarse_logits.device)
    over, rand = draws
    unc = calculate_uncertainty(point_sample(coarse_logits[:, None], over)[..., 0])
    n_imp = int(num_points * importance_sample_ratio)
    _, top = topk_stable(unc, n_imp)
    important = torch.gather(over, 1, top[..., None].expand(-1, -1, 2))
    return torch.cat([important, rand], dim=1)


class PointHead(nn.Module):
    """MLP over [fine feature, coarse logits] per point: ``fc0`` ...
    ``fc{num_layers - 1}`` (each followed by relu and the coarse logits
    again) and ``predictor``."""

    def __init__(self, in_channels: int, num_classes: int = 1, hidden: int = 256,
                 num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        dim = in_channels + num_classes
        for i in range(num_layers):
            self.add_module(f"fc{i}", Linear(dim, hidden))
            dim = hidden + num_classes
        self.predictor = Linear(dim, num_classes)

    def forward(self, fine: torch.Tensor, coarse: torch.Tensor) -> torch.Tensor:
        """fine (..., P, C), coarse (..., P, K) -> refined logits (..., P, K)."""
        x = torch.cat([fine, coarse], dim=-1)
        for i in range(self.num_layers):
            x = F.relu(getattr(self, f"fc{i}")(x))
            x = torch.cat([x, coarse], dim=-1)
        return self.predictor(x)


def refine_mask_inference(
    point_head: Callable,
    fine_feat: torch.Tensor,       # (N, C, H, W) per-ROI fine features
    coarse_logits: torch.Tensor,   # (N, M, M)
    num_steps: int = 2,
    points_per_step: int = 196,
    out_size: int = 56,
) -> torch.Tensor:
    """Subdivision inference: ``num_steps`` times upsample 2x (up to
    ``out_size``, as ``jax.image.resize`` bilinear), take the
    ``points_per_step`` most uncertain cells and write the point head's
    prediction there -> (N, S, S)."""
    logits = coarse_logits
    n = logits.shape[0]
    for _ in range(num_steps):
        new_size = min(logits.shape[1] * 2, out_size)
        logits = resize_bilinear(logits[:, None], (new_size, new_size))[:, 0]
        flat = logits.reshape(n, -1)
        k = min(points_per_step, flat.shape[1])
        _, idx = topk_stable(calculate_uncertainty(flat), k)
        ys = torch.div(idx, new_size, rounding_mode="floor").float()
        xs = (idx % new_size).float()
        pts = torch.stack([(xs + 0.5) / new_size, (ys + 0.5) / new_size], dim=-1)
        fine = point_sample(fine_feat, pts)
        coarse_at = torch.gather(flat, 1, idx)[..., None]
        refined = point_head(fine, coarse_at)[..., 0].to(flat.dtype)
        # the top-k cells are distinct: a scatter equals the one-hot update
        logits = flat.scatter(1, idx, refined).reshape(n, new_size, new_size)
    return logits


def point_rend_mask_loss(
    point_head: Callable,
    fine_feat: torch.Tensor,       # (N, C, H, W)
    coarse_logits: torch.Tensor,   # (N, M, M)
    gt_mask_fn: Callable,          # points (N, P, 2) in [0, 1] -> (N, P) targets
    num_points: int = 196,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """The point head's BCE at uncertainty-sampled points, averaged over
    every ROI's points (the mean of the JAX function's per-ROI values)."""
    pts = sample_uncertain_points(coarse_logits, num_points, generator=generator,
                                  draws=draws)
    fine = point_sample(fine_feat, pts)
    coarse = point_sample(coarse_logits[:, None], pts)
    logits = point_head(fine, coarse)[..., 0]
    return torch.mean(bce_with_logits(logits.float(), gt_mask_fn(pts)))
