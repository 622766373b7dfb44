"""The multilevel ROIAlign of the port's pooler kernels (K1 forward, K3
backward), as plain tensor operations: each ROI is routed to its FPN level,
bumped to a coarser one (up to a virtual level, a 2x average pool of the top
level) while its samples would not fit a ``WIN_Y`` x ``WIN`` window, and
pooled by separable bilinear weights over that window, ``sampling_ratio``
samples a bin side (2 when 0 or less). f32 ``(R, s, s, C)``, differentiable.

``MultiLevelPooler`` is the same function as a module, so a FLOP count can
tell the pooler's interpolation from the model's products.
"""
from __future__ import annotations

import itertools
import math
from typing import Sequence, Tuple

import torch
from torch import nn

from portbench.refmodel.consts import device_table, scalar
from portbench.refmodel.roi_align import assign_boxes_to_levels, log2

WIN = 40      # x window per ROI (the x origin is aligned down to 8)
WIN_Y = 32    # y window
# the most input cells a bin-sample span may cover so the window fits
SPAN_BUDGET = min(WIN - 11, WIN_Y - 4)


def _padded_dims(dims) -> Tuple[Tuple[int, int], ...]:
    """Zero-padded level dims so an 8-aligned WIN x WIN window always fits."""
    return tuple((max(h, WIN), max(((w + 7) // 8) * 8, WIN + 8))
                 for h, w in dims)


def _ml_prep(
    boxes: torch.Tensor,
    dims: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    s: int,
    r: int,
    canonical_box_size: float,
    canonical_level: int,
    n_virtual: int = 1,
    win_y: int = WIN_Y,
    win_x: int = WIN,
):
    """Per-ROI level (with the window-fit bump), window origins and bin
    geometry in level coordinates. ``dims``/``strides`` include the
    ``n_virtual`` trailing virtual levels, which only the bump reaches."""
    dev = boxes.device
    num_levels = len(dims)
    min_level = int(math.log2(strides[0]))
    levels = assign_boxes_to_levels(
        boxes, min_level, min_level + num_levels - 1 - n_virtual,
        canonical_box_size, canonical_level)
    lvl = (levels - min_level).long()
    max_side = torch.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
    strides_t = device_table(strides, torch.float32, dev)
    need = torch.ceil(log2(torch.clamp(
        max_side / strides_t[lvl] / scalar(SPAN_BUDGET, dev), min=1e-6))).long()
    lvl = torch.clamp(lvl + torch.clamp(need, min=0), 0, num_levels - 1)

    pdims = _padded_dims(dims)
    fb = boxes.to(torch.float32) / strides_t[lvl][:, None]
    y0 = fb[:, 1] - 0.5
    x0 = fb[:, 0] - 0.5
    bin_h = (fb[:, 3] - fb[:, 1]) / scalar(s, dev)
    bin_w = (fb[:, 2] - fb[:, 0]) / scalar(s, dev)

    pad_h = device_table([d[0] for d in pdims], torch.int64, dev)[lvl]
    pad_w = device_table([d[1] for d in pdims], torch.int64, dev)[lvl]
    first_y = torch.floor(y0 + bin_h * (0.5 / r)) - 1
    first_x = torch.floor(x0 + bin_w * (0.5 / r)) - 1
    oy = torch.minimum(torch.clamp(first_y, min=0),
                       (pad_h - win_y).to(torch.float32)).to(torch.int32)
    ox = torch.minimum(torch.clamp(first_x, min=0),
                       (pad_w - win_x).to(torch.float32)).to(torch.int32)
    ox = ox // 8 * 8
    return dict(lvl=lvl, oy=oy, ox=ox, y0=y0, x0=x0, bin_h=bin_h,
                bin_w=bin_w, pdims=pdims)


def _append_virtual_level(features, strides):
    """Append a 2x average pool of the top level (NHWC, odd dims
    edge-padded) as a virtual routing level."""
    f = features[-1]
    b, h, w, c = f.shape
    if h % 2:
        f = torch.cat([f, f[:, -1:]], dim=1)
    if w % 2:
        f = torch.cat([f, f[:, :, -1:]], dim=2)
    pooled = f.reshape(b, (h + 1) // 2, 2, (w + 1) // 2, 2, c).mean(dim=(2, 4))
    return list(features) + [pooled], tuple(strides) + (2 * strides[-1],)


def _rel_coords(s: int, r: int, device=None) -> torch.Tensor:
    """(s*r,) sample offsets in bin units: bin index + centered subsample."""
    idx = torch.arange(s * r, device=device)
    return ((idx // r).to(torch.float32)
            + ((idx % r).to(torch.float32) + 0.5) / r)


def _axis_weights_batch(coords, size, origin, win: int):
    """Bilinear weights of (R, n) sample coords over the ``win`` window
    cells: (R, n, win). Out-of-level samples weigh 0; in-level ones clamp into
    [0, size-1] and then into the window."""
    inside = (coords >= -1.0) & (coords <= size[:, None])
    cc = torch.minimum(torch.clamp(coords, min=0.0), size[:, None] - 1.0)
    local = torch.clamp(cc - origin[:, None].to(torch.float32), 0.0, win - 1.0)
    cells = torch.arange(win, dtype=torch.float32, device=coords.device)
    wgt = torch.clamp(1.0 - torch.abs(local[:, :, None] - cells), min=0.0)
    return wgt * inside[:, :, None]


def _ml_geometry(boxes, batch_idx, dims, strides, s, r, cbs, cl):
    """Per-ROI separable weights (R, n, WIN_Y) / (R, n, WIN) and flat window
    indices (R, WIN_Y, WIN) into the padded, flattened pyramid."""
    dev = boxes.device
    prep = _ml_prep(boxes, dims, strides, s, r, cbs, cl)
    lvl, oy, ox = prep["lvl"], prep["oy"], prep["ox"]
    pdims = prep["pdims"]
    true_h = device_table([d[0] for d in dims], torch.float32, dev)[lvl]
    true_w = device_table([d[1] for d in dims], torch.float32, dev)[lvl]
    rel = _rel_coords(s, r, dev)
    ys = prep["y0"][:, None] + rel[None, :] * prep["bin_h"][:, None]
    xs = prep["x0"][:, None] + rel[None, :] * prep["bin_w"][:, None]
    wy = _axis_weights_batch(ys, true_h, oy, WIN_Y)
    wx = _axis_weights_batch(xs, true_w, ox, WIN)

    sizes = [ph * pw for ph, pw in pdims]
    offsets = device_table([0, *itertools.accumulate(sizes)][:-1], torch.int64, dev)
    total = sum(sizes)
    pw_r = device_table([d[1] for d in pdims], torch.int64, dev)[lvl]
    base = batch_idx.to(torch.int64) * total + offsets[lvl]
    rows = (oy.long()[:, None] + torch.arange(WIN_Y, device=dev)) * pw_r[:, None]
    cols = ox.long()[:, None] + torch.arange(WIN, device=dev)
    idx = base[:, None, None] + rows[:, :, None] + cols[:, None, :]
    return wy, wx, idx, prep, total


def _pad_pyramid_flat(features, pdims) -> torch.Tensor:
    """Concatenate zero-padded NHWC levels into one (B*total, C) buffer."""
    b, c = features[0].shape[0], features[0].shape[-1]
    flat = []
    for f, (ph, pw) in zip(features, pdims):
        f = torch.nn.functional.pad(
            f, (0, 0, 0, pw - f.shape[2], 0, ph - f.shape[1]))
        flat.append(f.reshape(b, -1, c))
    return torch.cat(flat, dim=1).reshape(-1, c)


def multilevel_roi_align_ref(
    features, boxes, batch_idx, output_size, strides,
    sampling_ratio: int = 2, canonical_box_size: float = 224.0,
    canonical_level: int = 4,
) -> torch.Tensor:
    """Plain version of the kernel (window gather + separable contractions),
    f32 ``(R, s, s, C)``; under autograd also the plain version of the
    backward kernel."""
    if sampling_ratio <= 0:
        sampling_ratio = 2
    features, strides = _append_virtual_level(features, tuple(strides))
    return _ref_ext(features, boxes, batch_idx, output_size, strides,
                    sampling_ratio, canonical_box_size, canonical_level)


def _ref_ext(features, boxes, batch_idx, s, strides, r, cbs, cl) -> torch.Tensor:
    """``multilevel_roi_align_ref`` on a level list that already ends in the
    virtual level."""
    dims = tuple((f.shape[1], f.shape[2]) for f in features)
    wy, wx, idx, prep, _ = _ml_geometry(boxes, batch_idx, dims, strides, s, r,
                                        cbs, cl)
    flat = _pad_pyramid_flat(features, prep["pdims"]).to(torch.float32)
    win = flat[idx]                                     # (R, WIN_Y, WIN, C)
    out = torch.einsum("rni,rijc->rnjc", wy, win)
    out = torch.einsum("rmj,rnjc->rnmc", wx, out)
    n_roi, c = boxes.shape[0], features[0].shape[-1]
    return out.reshape(n_roi, s, r, s, r, c).mean(dim=(2, 4))


class MultiLevelPooler(nn.Module):
    """``multilevel_roi_align_ref`` as a module without parameters."""

    def forward(self, features: Sequence[torch.Tensor], boxes: torch.Tensor,
                batch_idx: torch.Tensor, output_size: int,
                strides: Tuple[int, ...], sampling_ratio: int) -> torch.Tensor:
        return multilevel_roi_align_ref(features, boxes, batch_idx, output_size,
                                        strides, sampling_ratio)
