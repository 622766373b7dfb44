"""Multilevel FPN ROIAlign: the hand-written CUDA kernel and its plain twin.

This is ``pooler_impl="pallas"`` of the JAX package
(``u2seg_tpu/ops/roi_align_pallas.py``). Its semantics differ from the gather
pooler in two ways, both kept here:

- routing: the canonical sqrt-area level, bumped one or more levels coarser
  when the box's long side exceeds ``SPAN_BUDGET`` cells there (window fit),
  up to a VIRTUAL top level: a 2x average pool (edge-padded) of the top real
  level;
- sampling: each ROI reads a ``WIN_Y x WIN`` window of its (zero-padded)
  level, and every sample coordinate is clipped into that window.

Plain twins of the JAX functions (same names, same f32 op order):
``_ml_prep``, ``_append_virtual_level``, ``_pooled_axis_weights_host``,
``_ml_geometry`` and ``multilevel_roi_align_ref``. The twin is the CPU path
and the yardstick the kernel is held to on the card.

``multilevel_roi_align_kernel`` is the wrapper: for CPU tensors it returns the
twin; for CUDA tensors it launches ``csrc/roi_align_ml.cu`` or raises. It
counts its launches in ``multilevel_roi_align_kernel.launches``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import math
from typing import List, Sequence, Tuple

import torch

from u2seg_torch import _cuda
from u2seg_torch.ops.consts import device_table, scalar
from u2seg_torch.ops.roi_align import assign_boxes_to_levels, log2

WIN = 40      # x window per ROI (the x origin is aligned down to 8)
WIN_Y = 32    # y window
# largest box span (feature cells) the windows cover exactly, halos and the
# 8-alignment slack included
SPAN_BUDGET = min(WIN - 11, WIN_Y - 4)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def _pooled_axis_weights_host(c0, binsz, origin, size, s: int, r: int,
                              win: int) -> torch.Tensor:
    """The window weights of K1 (the streamed-weight TPU kernel): (R, s, win)
    f32 with the r-sample mean folded in."""
    n = s * r
    idx = torch.arange(n, dtype=torch.float32, device=c0.device)
    rel = torch.floor(idx / r) + ((idx % r) + 0.5) / r
    coords = c0[:, None] + rel[None, :] * binsz[:, None]
    inside = (coords >= -1.0) & (coords <= size[:, None])
    cc = torch.minimum(torch.clamp(coords, min=0.0),
                       torch.clamp(size[:, None] - 1.0, min=0.0))
    local = torch.clamp(cc - origin[:, None].to(torch.float32), 0.0, win - 1.0)
    cells = torch.arange(win, dtype=torch.float32, device=c0.device)
    wgt = torch.clamp(1.0 - torch.abs(local[..., None] - cells), min=0.0)
    wgt = wgt * inside[..., None]
    return wgt.reshape(-1, s, r, win).sum(dim=2) * (1.0 / r)


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
    f32 ``(R, s, s, C)``."""
    if sampling_ratio <= 0:
        sampling_ratio = 2
    s, r = output_size, sampling_ratio
    features, strides = _append_virtual_level(features, tuple(strides))
    dims = tuple((f.shape[1], f.shape[2]) for f in features)
    wy, wx, idx, prep, _ = _ml_geometry(
        boxes, batch_idx, dims, strides, s, r, canonical_box_size,
        canonical_level)
    flat = _pad_pyramid_flat(features, prep["pdims"]).to(torch.float32)
    win = flat[idx]                                     # (R, WIN_Y, WIN, C)
    out = torch.einsum("rni,rijc->rnjc", wy, win)
    out = torch.einsum("rmj,rnjc->rnmc", wx, out)
    n_roi, c = boxes.shape[0], features[0].shape[-1]
    return out.reshape(n_roi, s, r, s, r, c).mean(dim=(2, 4))


def multilevel_roi_align_kernel(
    features: Sequence[torch.Tensor],   # (B, H_l, W_l, C), fine -> coarse
    boxes: torch.Tensor,                # (R, 4) f32 XYXY image coords
    batch_idx: torch.Tensor,            # (R,) int
    output_size: int,
    strides: Sequence[int],
    sampling_ratio: int = 2,
    canonical_box_size: float = 224.0,
    canonical_level: int = 4,
    out_dtype: torch.dtype = None,      # None -> float32
) -> torch.Tensor:
    """FPN ROIPooler with the multilevel ROIAlign kernel -> (R, s, s, C).

    CPU tensors take the plain twin. CUDA tensors launch the kernel; any
    input the kernel does not take raises."""
    out_dtype = out_dtype or torch.float32
    if boxes.device.type == "cpu":
        return multilevel_roi_align_ref(
            features, boxes, batch_idx, output_size, strides, sampling_ratio,
            canonical_box_size, canonical_level).to(out_dtype)
    if sampling_ratio <= 0:
        sampling_ratio = 2
    s, r = output_size, sampling_ratio
    dev = boxes.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    dtype = features[0].dtype
    b, _, _, c = features[0].shape
    for f in features:
        if f.device != dev or f.dtype != dtype or f.dim() != 4:
            raise ValueError("levels must be 4-D tensors of one dtype on the "
                             "boxes' device")
        if f.shape[0] != b or f.shape[3] != c or not f.is_contiguous():
            raise ValueError("levels must be contiguous (B, H, W, C) with one "
                             "B and C")
    if dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtypes {dtype} -> {out_dtype}")
    if c % 2 or s * r > 64 or len(features) + 1 > 8:
        raise ValueError("kernel needs an even C, s*r <= 64 and <= 7 levels")
    if (boxes.dtype != torch.float32 or boxes.dim() != 2 or boxes.shape[1] != 4
            or batch_idx.shape != boxes.shape[:1] or batch_idx.device != dev):
        raise ValueError("boxes must be (R, 4) float32 with (R,) batch_idx")

    args = prepare_launch(features, boxes, batch_idx, s, r, strides,
                          canonical_box_size, canonical_level, out_dtype)
    return launch(args)


@dataclasses.dataclass
class LaunchArgs:
    """Everything one kernel launch reads: the levels (virtual one
    appended), per-ROI routing and geometry, and the output buffer."""
    levels: List[torch.Tensor]
    roi_i: torch.Tensor      # (R, 4) int32: level, window oy, ox, batch index
    roi_f: torch.Tensor      # (R, 4) f32: y0, x0, bin_h, bin_w (level coords)
    out: torch.Tensor        # (R, s, s, C)
    s: int
    r: int


def prepare_launch(features, boxes, batch_idx, s, r, strides,
                   canonical_box_size, canonical_level, out_dtype) -> LaunchArgs:
    """The wrapper's device-side prep: virtual level and routing (torch ops on
    the card, as the JAX package runs them outside its kernel)."""
    feats, strides_ext = _append_virtual_level(features, tuple(strides))
    feats = [f.contiguous() for f in feats]
    if any(f.data_ptr() % 8 for f in feats):
        raise ValueError("level storage must be 8-byte aligned")
    dims = tuple((f.shape[1], f.shape[2]) for f in feats)
    prep = _ml_prep(boxes, dims, strides_ext, s, r, canonical_box_size,
                    canonical_level)
    roi_i = torch.stack([prep["lvl"].to(torch.int32), prep["oy"], prep["ox"],
                         batch_idx.to(torch.int32)], dim=1).contiguous()
    roi_f = torch.stack([prep["y0"], prep["x0"], prep["bin_h"],
                         prep["bin_w"]], dim=1).contiguous()
    out = torch.empty((boxes.shape[0], s, s, feats[0].shape[-1]),
                      dtype=out_dtype, device=boxes.device)
    return LaunchArgs(feats, roi_i, roi_f, out, s, r)


@functools.lru_cache(maxsize=None)
def _forward_fn():
    lib = _cuda.load("roi_align_ml")
    fn = lib.u2seg_roi_align_ml_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return lib, fn


def launch(a: LaunchArgs) -> torch.Tensor:
    """Launch ``csrc/roi_align_ml.cu`` on the current stream; counts the
    launch in ``multilevel_roi_align_kernel.launches``."""
    lib, fn = _forward_fn()
    nl = len(a.levels)
    ptrs = (ctypes.c_int64 * nl)(*[f.data_ptr() for f in a.levels])
    hs = (ctypes.c_int * nl)(*[f.shape[1] for f in a.levels])
    ws = (ctypes.c_int * nl)(*[f.shape[2] for f in a.levels])
    as_ptr = lambda arr: ctypes.cast(arr, ctypes.c_void_p)
    n_roi, _, _, c = a.out.shape
    code = fn(as_ptr(ptrs), as_ptr(hs), as_ptr(ws), nl, a.roi_i.data_ptr(),
              a.roi_f.data_ptr(), a.out.data_ptr(), n_roi, c, a.s, a.r,
              WIN_Y, WIN, _DTYPE_CODES[a.levels[0].dtype],
              _DTYPE_CODES[a.out.dtype],
              torch.cuda.current_stream(a.out.device).cuda_stream)
    _cuda.check(lib, code, "roi_align_ml launch")
    multilevel_roi_align_kernel.launches += 1
    return a.out


multilevel_roi_align_kernel.launches = 0
