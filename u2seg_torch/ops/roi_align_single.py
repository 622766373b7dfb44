"""Single-level aligned ROIAlign from one 40 x 40 window per ROI: the
hand-written CUDA kernel and its plain version (counterpart of
``roi_align_pallas`` in ``u2seg_tpu/ops/roi_align_pallas.py``).

Its semantics are the window kernel's, not the gather pooler's
(``ops/roi_align.py::roi_align``): each ROI reads the ``WIN x WIN`` cells at
its window origin (``floor(first sample) - 1`` clipped to ``[0, size -
WIN]``, the x origin aligned down to a multiple of 8), and a sample that
falls outside those cells contributes zero. For boxes that fit the window
the two poolers agree. Maps smaller than the window are not supported.

``roi_align_single`` is the wrapper: CPU tensors take ``roi_align_single_ref``;
CUDA tensors launch ``csrc/roi_align_single.cu`` or raise. It counts its
launches in ``roi_align_single.launches``. Output is ``(R, s, s, C)`` f32 for
every input type.

The kernel is a span kernel, as the multilevel forward is
(``ops/roi_align_ml.py``; the source's header has the detail): the r-sample
mean is folded into dense per-axis weights ``Wy``, ``Wx`` (R, s, WIN)
(``pooled_axis_weights`` returns them), the output of one ROI is
``Wy @ window @ Wx^T``, and every cell of non-zero weight lies inside the
window and the map. One block serves one (ROI, chunk of ``CHUNK`` = 64
channels) and copies the rows of the ROI's span into a stage buffer in shared
memory with 16-byte copies; block size and buffer come from ``launch_plan``.
So C must be a multiple of 8 and storage 16-byte aligned: ``check_contract``
raises otherwise.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from u2seg_torch import _cuda
from u2seg_torch.ops.consts import scalar
from u2seg_torch.ops.roi_align_ml import (
    CHUNK, check_aligned, check_launch_plan, table_bytes)

WIN = 40      # window cells per axis

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _prep(boxes: torch.Tensor, h: int, w: int, s: int, r: int,
          spatial_scale: float):
    """Per-ROI bin geometry (R, 4) f32 (y0, x0, bin_h, bin_w in feature
    coordinates) and window origins (R, 2) int32 (oy, ox)."""
    if h < WIN or w < WIN:
        raise ValueError(f"feature map {h} x {w} is smaller than the "
                         f"{WIN} x {WIN} window")
    dev = boxes.device
    fb = boxes.to(torch.float32) * spatial_scale
    y0 = fb[:, 1] - 0.5
    x0 = fb[:, 0] - 0.5
    bin_h = (fb[:, 3] - fb[:, 1]) / scalar(s, dev)
    bin_w = (fb[:, 2] - fb[:, 0]) / scalar(s, dev)
    meta = torch.stack([y0, x0, bin_h, bin_w], dim=1).contiguous()
    first_y = torch.floor(y0 + bin_h * (0.5 / r)) - 1
    first_x = torch.floor(x0 + bin_w * (0.5 / r)) - 1
    oy = torch.clamp(first_y, 0, h - WIN).to(torch.int32)
    ox = torch.clamp(first_x, 0, w - WIN).to(torch.int32) // 8 * 8
    return meta, torch.stack([oy, ox], dim=1).contiguous()


def _axis_weights(c0, binsz, size: int, origin, s: int, r: int) -> torch.Tensor:
    """(R, s*r, WIN) f32 weights of the window's cells: 0 for a sample
    outside [-1, size]; inside, the sample is clamped into [0, size - 1] and
    weighs ``relu(1 - |local - cell|)`` on cells 0..WIN-1."""
    idx = torch.arange(s * r, device=c0.device)
    rel = ((idx // r).to(torch.float32)
           + ((idx % r).to(torch.float32) + 0.5) / r)
    coords = c0[:, None] + rel[None, :] * binsz[:, None]
    inside = (coords >= -1.0) & (coords <= float(size))
    cc = torch.clamp(coords, 0.0, size - 1.0)
    local = cc - origin[:, None].to(torch.float32)
    cells = torch.arange(WIN, dtype=torch.float32, device=c0.device)
    wgt = torch.clamp(1.0 - torch.abs(local[:, :, None] - cells), min=0.0)
    return wgt * inside[:, :, None]


def pooled_axis_weights(boxes: torch.Tensor, h: int, w: int, s: int, r: int,
                        spatial_scale: float):
    """The kernel's dense per-axis tables: ``Wy``, ``Wx`` (R, s, WIN) f32 over
    the window's cells with the r-sample mean folded in, and the window
    origins (R, 2) int32. One ROI pools to ``Wy @ window @ Wx^T``."""
    meta, origin = _prep(boxes, h, w, s, r, spatial_scale)
    wy = _axis_weights(meta[:, 0], meta[:, 2], h, origin[:, 0], s, r)
    wx = _axis_weights(meta[:, 1], meta[:, 3], w, origin[:, 1], s, r)
    fold = lambda t: t.reshape(-1, s, r, WIN).sum(dim=2) * (1.0 / r)
    return fold(wy), fold(wx), origin


def roi_align_single_ref(features: torch.Tensor, boxes: torch.Tensor,
                         batch_idx: torch.Tensor, output_size: int,
                         spatial_scale: float,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """Plain version of the kernel, as the TPU kernel's body computes it:
    the two weight matrices, ``Wy @ window @ Wx^T``, then the ``r x r`` mean.
    f32 ``(R, s, s, C)``."""
    if sampling_ratio <= 0:
        sampling_ratio = 2
    s, r = output_size, sampling_ratio
    _, h, w, c = features.shape
    meta, origin = _prep(boxes, h, w, s, r, spatial_scale)
    oy, ox = origin[:, 0], origin[:, 1]
    wy = _axis_weights(meta[:, 0], meta[:, 2], h, oy, s, r)     # (R, n, WIN)
    wx = _axis_weights(meta[:, 1], meta[:, 3], w, ox, s, r)
    cells = torch.arange(WIN, device=boxes.device)
    rows = oy.long()[:, None] + cells
    cols = ox.long()[:, None] + cells
    window = features[batch_idx.long()[:, None, None], rows[:, :, None],
                      cols[:, None, :]].to(torch.float32)       # (R, WIN, WIN, C)
    tmp = torch.einsum("rni,rijc->rnjc", wy, window)
    out = torch.einsum("rmj,rnjc->rnmc", wx, tmp)               # (R, n, n, C)
    return out.reshape(boxes.shape[0], s, r, s, r, c).mean(dim=(2, 4))


def launch_plan(s: int) -> Tuple[int, int]:
    """Block size and stage buffer of the launch: 128 threads and 24 KB for
    every output size, measured fastest on the card at s=7 and s=14 among 15
    plans (``python3 -m u2seg_torch.dev.time_roi_align_single``; a 14 x 14
    output runs 10% faster than with 256 threads and 48 KB). 128 threads
    cover the 2 s table builders of every s the kernel takes (s * r <= 64),
    and 24 KB hold a row of the widest span (WIN cells of CHUNK f32
    channels), as the source requires."""
    return 128, 24576


def shared_bytes(s: int, stage_bytes: int) -> int:
    """Dynamic shared memory of one block: stage buffer + the dense tables
    (``smem_bytes`` of the source)."""
    return stage_bytes + table_bytes(s, WIN, WIN)


def check_contract(features: torch.Tensor, s: int, r: int) -> None:
    """Raise on a map or a launch the kernel does not take: dtype, layout,
    size, channels (a multiple of 8), s * r, shared memory and alignment.
    Works on tensors of any device."""
    if features.dim() != 4 or not features.is_contiguous():
        raise ValueError("features must be a contiguous (B, H, W, C) tensor")
    if features.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {features.dtype}")
    _, h, w, c = features.shape
    if h < WIN or w < WIN:
        raise ValueError(f"feature map {h} x {w} is smaller than the "
                         f"{WIN} x {WIN} window")
    check_launch_plan(s, r, c, shared_bytes(s, launch_plan(s)[1]))
    check_aligned([features], "feature map")


def _check_inputs(features, boxes, batch_idx, s, r):
    """Raise on what the kernel does not take."""
    dev = boxes.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if features.device != dev:
        raise ValueError("features must lie on the boxes' device")
    check_contract(features, s, r)
    if (boxes.dtype != torch.float32 or boxes.dim() != 2 or boxes.shape[1] != 4
            or batch_idx.shape != boxes.shape[:1] or batch_idx.device != dev):
        raise ValueError("boxes must be (R, 4) float32 with (R,) batch_idx")


def roi_align_single(features: torch.Tensor, boxes: torch.Tensor,
                     batch_idx: torch.Tensor, output_size: int,
                     spatial_scale: float,
                     sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign (aligned) of ``boxes`` (R, 4) XYXY image coords on one
    ``(B, H, W, C)`` map -> ``(R, s, s, C)`` f32.

    CPU tensors take the plain version. CUDA tensors launch the kernel; any
    input the kernel does not take raises."""
    if boxes.device.type == "cpu":
        return roi_align_single_ref(features, boxes, batch_idx, output_size,
                                    spatial_scale, sampling_ratio)
    if sampling_ratio <= 0:
        sampling_ratio = 2
    s, r = output_size, sampling_ratio
    _check_inputs(features, boxes, batch_idx, s, r)
    return launch(prepare_launch(features, boxes, batch_idx, s, r, spatial_scale))


@dataclasses.dataclass
class LaunchArgs:
    """Everything one launch reads and writes."""
    features: torch.Tensor   # (B, H, W, C) f32 or bf16
    origin: torch.Tensor     # (R, 2) int32: window oy, ox
    batch: torch.Tensor      # (R,) int32
    meta: torch.Tensor       # (R, 4) f32: y0, x0, bin_h, bin_w (map coords)
    out: torch.Tensor        # (R, s, s, C) f32
    s: int
    r: int


def prepare_launch(features, boxes, batch_idx, s, r, spatial_scale) -> LaunchArgs:
    """The wrapper's device-side prep: bin geometry and window origins (torch
    ops on the card), and the output buffer."""
    _, h, w, c = features.shape
    meta, origin = _prep(boxes, h, w, s, r, spatial_scale)
    out = torch.empty((boxes.shape[0], s, s, c), dtype=torch.float32,
                      device=features.device)
    check_aligned([out], "output")
    return LaunchArgs(features, origin, batch_idx.to(torch.int32).contiguous(),
                      meta, out, s, r)


def _c_fn(name: str, argtypes):
    lib = _cuda.load("roi_align_single")
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return lib, fn


@functools.lru_cache(maxsize=None)
def _forward_fn():
    return _c_fn("u2seg_roi_align_single_forward",
                 [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
                 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def kernel_shared_bytes(s: int) -> int:
    """What the built library itself says one block takes (builds it)."""
    _, fn = _c_fn("u2seg_roi_align_single_smem_bytes", [ctypes.c_int] * 3)
    return fn(s, WIN, launch_plan(s)[1])


def launch(a: LaunchArgs) -> torch.Tensor:
    """Launch ``csrc/roi_align_single.cu`` on the current stream; counts the
    launch in ``roi_align_single.launches``."""
    n_roi = a.origin.shape[0]
    if n_roi == 0:          # nothing to launch, nothing to count
        return a.out
    lib, fn = _forward_fn()
    b, h, w, c = a.features.shape
    threads, stage_bytes = launch_plan(a.s)
    check_launch_plan(a.s, a.r, c, shared_bytes(a.s, stage_bytes))
    code = fn(a.features.data_ptr(), b, h, w, c, a.origin.data_ptr(),
              a.batch.data_ptr(), a.meta.data_ptr(), a.out.data_ptr(), n_roi,
              a.s, a.r, WIN, _DTYPE_CODES[a.features.dtype], threads, stage_bytes,
              torch.cuda.current_stream(a.out.device).cuda_stream)
    _cuda.check(lib, code, "roi_align_single launch")
    roi_align_single.launches += 1
    return a.out


roi_align_single.launches = 0
