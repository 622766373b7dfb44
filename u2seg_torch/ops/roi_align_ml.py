"""Multilevel FPN ROIAlign: the hand-written CUDA kernels and their plain twin.

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
and the yardstick the kernels are held to on the card.

``multilevel_roi_align_kernel`` is the wrapper: for CPU tensors it returns the
twin; for CUDA tensors it launches ``csrc/roi_align_ml.cu`` or raises. It
counts its launches in ``multilevel_roi_align_kernel.launches``.

``multilevel_roi_align_train`` is the differentiable pooler of the train
path (``multilevel_roi_align_train`` of the JAX package): f32 out, gradient
w.r.t. the levels only. On CUDA tensors it is a ``torch.autograd.Function``
whose forward is the kernel above and whose backward is the second kernel
of the same source (the port of the TPU kernel ``_ml_bwd_kernel``), counted
in ``multilevel_roi_align_backward.launches``; on CPU tensors it is the
twin under autograd, which is also the backward kernel's plain version. The
backward kernel adds with atomics and is not deterministic: under
``torch.use_deterministic_algorithms(True)`` it raises
(``check_deterministic_backward``).

The kernels' design (the source's header has the detail). For one ROI the
pooled output is ``einsum(Wy, Wx, window)`` with the dense per-axis weights of
``_pooled_axis_weights_host`` (``dense_axis_weights`` below returns them per
ROI), and the backward is its transpose. Every cell of non-zero weight lies
inside the ROI's window and inside the true level dims; the box of those cells
is the ROI's *span* (``roi_spans``). One block serves one (ROI, chunk of
``CHUNK`` = 64 channels): the forward copies the rows of the span that a group
of output rows needs into a buffer in shared memory (block size and buffer
from ``forward_plan``) with 16-byte copies and interpolates from there; the
backward
keeps the ROI's cotangent tile in shared memory and makes one 16-byte vector
atomic per (span cell, 4 channels). Both are bound by bytes on the card. That
is why C must be a multiple of 8 and all storage 16-byte aligned:
``_check_inputs`` and ``_prepare_ext`` raise otherwise. The single-level
window kernel (``ops/roi_align_single.py``) is built on the same design and
shares the launch-plan helpers below.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import math
import warnings
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

# The span kernels' launch plan. One block per (ROI, chunk of channels).
CHUNK = 64                 # channels per block (kChunk of the source)
STAGE_BYTES = 49152        # forward: the largest stage buffer forward_plan picks
MAX_SHARED_BYTES = 232448  # 227 KB: the most dynamic shared memory of a block
MAX_SAMPLES = 64           # s * r along one axis
ALIGN = 16                 # bytes: every global access is a 16-byte vector
CHANNEL_MULTIPLE = 8       # 8 bf16 = 16 bytes; f32 output units are 8 wide too


def table_bytes(s: int, win_y: int = WIN_Y, win_x: int = WIN) -> int:
    """Shared memory of one block's dense weight tables: Wy (s, win_y), Wx
    (s, win_x), per-bin and per-cell ranges (``table_bytes`` of
    ``csrc/span_common.cuh``)."""
    return 4 * (s * (win_y + win_x) + 4 * s + 2 * (win_y + win_x))


def forward_shared_bytes(s: int, stage_bytes: int = STAGE_BYTES) -> int:
    """Dynamic shared memory of one forward block: stage buffer + tables."""
    return stage_bytes + table_bytes(s)


def backward_shared_bytes(s: int) -> int:
    """Dynamic shared memory of one backward block: the ROI's f32 cotangent
    tile (s, s, CHUNK) + tables."""
    return s * s * CHUNK * 4 + table_bytes(s)


def forward_plan(s: int) -> Tuple[int, int]:
    """Block size and stage buffer of the forward launch, by measurement on
    the card (``python3 -m u2seg_torch.dev.sweep_forward_plan`` times the
    alternatives): a 7 x 7 output has 392 8-channel values per 64-channel
    block, which 128 threads cover in 3 rounds with 8 blocks resident per SM;
    a 14 x 14 output has 1568 and takes 256 threads and a 48 KB buffer (fewer
    groups of rows; 4 blocks resident per SM). Every plan holds a row of the widest span (WIN cells of
    CHUNK f32 channels) and has at least 2 s threads, as the source requires."""
    return (128, 24576) if s * s <= 64 else (256, 49152)


def check_launch_plan(s: int, r: int, channels: int, shared_bytes: int) -> None:
    """Raise on a launch the span kernels do not take."""
    if s < 1 or r < 1 or s * r > MAX_SAMPLES:
        raise ValueError(f"kernel needs 1 <= s * r <= {MAX_SAMPLES}, got s={s} r={r}")
    if channels < CHANNEL_MULTIPLE or channels % CHANNEL_MULTIPLE:
        raise ValueError(f"kernel needs C to be a multiple of {CHANNEL_MULTIPLE} "
                         f"(16-byte vectors), got C={channels}")
    if shared_bytes > MAX_SHARED_BYTES:
        raise ValueError(f"s={s} needs {shared_bytes} bytes of shared memory per "
                         f"block, above {MAX_SHARED_BYTES}")


def check_aligned(tensors, what: str) -> None:
    """Raise unless every tensor's storage is ``ALIGN``-byte aligned."""
    if any(t.data_ptr() % ALIGN for t in tensors):
        raise ValueError(f"{what} storage must be {ALIGN}-byte aligned")


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


def dense_axis_weights(boxes, dims, strides, s, r, cbs=224.0, cl=4):
    """The kernels' per-ROI tables: ``Wy`` (R, s, WIN_Y) and ``Wx`` (R, s, WIN)
    over window cells, and the routing. ``dims``/``strides`` include the
    virtual level."""
    dev = boxes.device
    prep = _ml_prep(boxes, dims, strides, s, r, cbs, cl)
    lvl = prep["lvl"]
    true_h = device_table([d[0] for d in dims], torch.float32, dev)[lvl]
    true_w = device_table([d[1] for d in dims], torch.float32, dev)[lvl]
    wy = _pooled_axis_weights_host(prep["y0"], prep["bin_h"], prep["oy"], true_h,
                                   s, r, WIN_Y)
    wx = _pooled_axis_weights_host(prep["x0"], prep["bin_w"], prep["ox"], true_w,
                                   s, r, WIN)
    return wy, wx, prep


def roi_spans(wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """(R, 4) int64 window-local ``y_lo, y_hi, x_lo, x_hi`` (inclusive) of the
    cells with a non-zero weight; ``lo > hi`` where an axis has none."""
    def axis(w):
        hit = (w != 0).any(dim=1)                        # (R, win)
        cells = torch.arange(w.shape[-1], device=w.device)
        lo = torch.where(hit, cells, w.shape[-1]).amin(dim=1)
        hi = torch.where(hit, cells, -1).amax(dim=1)
        return lo, hi
    y_lo, y_hi = axis(wy)
    x_lo, x_hi = axis(wx)
    return torch.stack([y_lo, y_hi, x_lo, x_hi], dim=1)


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
    _check_inputs(features, boxes, batch_idx, s, r, out_dtype)
    args = prepare_launch(features, boxes, batch_idx, s, r, strides,
                          canonical_box_size, canonical_level, out_dtype)
    return launch(args)


def _check_inputs(features, boxes, batch_idx, s, r, out_dtype):
    """Raise on what the kernels do not take."""
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
    if len(features) + 1 > 8:
        raise ValueError("kernel takes <= 7 levels")
    check_launch_plan(s, r, c, forward_shared_bytes(s, forward_plan(s)[1]))
    if (boxes.dtype != torch.float32 or boxes.dim() != 2 or boxes.shape[1] != 4
            or batch_idx.shape != boxes.shape[:1] or batch_idx.device != dev):
        raise ValueError("boxes must be (R, 4) float32 with (R,) batch_idx")


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
    return _prepare_ext(feats, boxes, batch_idx, s, r, strides_ext,
                        canonical_box_size, canonical_level, out_dtype)


def _prepare_ext(feats, boxes, batch_idx, s, r, strides_ext,
                 canonical_box_size, canonical_level, out_dtype) -> LaunchArgs:
    """``prepare_launch`` on a level list that already ends in the virtual
    level."""
    feats = [f.contiguous() for f in feats]
    check_aligned(feats, "level")
    dims = tuple((f.shape[1], f.shape[2]) for f in feats)
    prep = _ml_prep(boxes, dims, strides_ext, s, r, canonical_box_size,
                    canonical_level)
    roi_i = torch.stack([prep["lvl"].to(torch.int32), prep["oy"], prep["ox"],
                         batch_idx.to(torch.int32)], dim=1).contiguous()
    roi_f = torch.stack([prep["y0"], prep["x0"], prep["bin_h"],
                         prep["bin_w"]], dim=1).contiguous()
    out = torch.empty((boxes.shape[0], s, s, feats[0].shape[-1]),
                      dtype=out_dtype, device=boxes.device)
    check_aligned([roi_i, roi_f, out], "ROI table and output")
    return LaunchArgs(feats, roi_i, roi_f, out, s, r)


def _c_fn(name: str, argtypes):
    lib = _cuda.load("roi_align_ml")
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return lib, fn


@functools.lru_cache(maxsize=None)
def _forward_fn():
    return _c_fn("u2seg_roi_align_ml_forward",
                 [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                 + [ctypes.c_int] * 10 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _backward_fn():
    return _c_fn("u2seg_roi_align_ml_backward",
                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def kernel_shared_bytes(backward: bool, s: int) -> int:
    """What the built library itself says one block takes (builds it)."""
    _, fn = _c_fn("u2seg_roi_align_ml_smem_bytes", [ctypes.c_int] * 5)
    return fn(int(backward), s, WIN_Y, WIN, forward_plan(s)[1])


def _level_tables(levels):
    nl = len(levels)
    ptrs = (ctypes.c_int64 * nl)(*[f.data_ptr() for f in levels])
    hs = (ctypes.c_int * nl)(*[f.shape[1] for f in levels])
    ws = (ctypes.c_int * nl)(*[f.shape[2] for f in levels])
    as_ptr = lambda arr: ctypes.cast(arr, ctypes.c_void_p)
    return as_ptr(ptrs), as_ptr(hs), as_ptr(ws), (ptrs, hs, ws)


def launch(a: LaunchArgs) -> torch.Tensor:
    """Launch the span forward kernel of ``csrc/roi_align_ml.cu`` on the
    current stream; counts the launch in
    ``multilevel_roi_align_kernel.launches``."""
    threads, stage_bytes = forward_plan(a.s)
    n_roi, _, _, c = a.out.shape
    check_launch_plan(a.s, a.r, c, forward_shared_bytes(a.s, stage_bytes))
    lib, fn = _forward_fn()
    ptrs, hs, ws, _keep = _level_tables(a.levels)
    code = fn(ptrs, hs, ws, len(a.levels), a.roi_i.data_ptr(),
              a.roi_f.data_ptr(), a.out.data_ptr(), n_roi, c, a.s, a.r,
              WIN_Y, WIN, _DTYPE_CODES[a.levels[0].dtype],
              _DTYPE_CODES[a.out.dtype], threads, stage_bytes,
              torch.cuda.current_stream(a.out.device).cuda_stream)
    _cuda.check(lib, code, "roi_align_ml launch")
    multilevel_roi_align_kernel.launches += 1
    return a.out


multilevel_roi_align_kernel.launches = 0


# ---------------------------------------------------------------------------
# The train pooler: kernel forward, kernel backward
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BackwardArgs:
    """Everything one backward launch reads and writes."""
    g: torch.Tensor              # (R, s, s, C) f32 contiguous cotangent
    roi_i: torch.Tensor          # as LaunchArgs
    roi_f: torch.Tensor
    grads: List[torch.Tensor]    # f32 (B, H_l, W_l, C) per extended level
    s: int
    r: int


def prepare_backward(g, roi_i, roi_f, shapes, s, r) -> BackwardArgs:
    """Allocate the f32 gradient levels at their true dims (the launch zeroes
    them) and bring the cotangent to contiguous f32."""
    if g.device.type != "cuda" or g.shape != (roi_i.shape[0], s, s, shapes[0][3]):
        raise ValueError("cotangent must be a CUDA tensor of shape (R, s, s, C)")
    g = g.to(torch.float32).contiguous()
    grads = [torch.empty(sh, dtype=torch.float32, device=g.device)
             for sh in shapes]
    check_aligned([g, *grads], "cotangent and gradient")
    return BackwardArgs(g, roi_i, roi_f, grads, s, r)


def multilevel_roi_align_backward(a: BackwardArgs) -> List[torch.Tensor]:
    """Launch the span backward kernel of ``csrc/roi_align_ml.cu`` on the
    current stream: zero ``a.grads``, then add every ROI's span cotangent into
    them. Counts the launch in ``multilevel_roi_align_backward.launches``."""
    n_roi, _, _, c = a.g.shape
    check_launch_plan(a.s, a.r, c, backward_shared_bytes(a.s))
    lib, fn = _backward_fn()
    ptrs, hs, ws, _keep = _level_tables(a.grads)
    code = fn(ptrs, hs, ws, len(a.grads), a.grads[0].shape[0],
              a.roi_i.data_ptr(), a.roi_f.data_ptr(), a.g.data_ptr(), n_roi, c,
              a.s, a.r, WIN_Y, WIN,
              torch.cuda.current_stream(a.g.device).cuda_stream)
    _cuda.check(lib, code, "roi_align_ml backward launch")
    multilevel_roi_align_backward.launches += 1
    return a.grads


multilevel_roi_align_backward.launches = 0


def check_deterministic_backward() -> None:
    """K3 adds each ROI's cotangent into the level gradients with atomics,
    whose order changes from run to run, so its gradients may differ in the
    last bits between two runs on the same inputs (the Pallas backward adds
    ROI after ROI in grid order and repeats exactly). Under
    ``torch.use_deterministic_algorithms(True)`` raise, as torch's own
    non-deterministic CUDA ops do; with ``warn_only=True`` warn."""
    if not torch.are_deterministic_algorithms_enabled():
        return
    msg = ("multilevel_roi_align_train's CUDA backward (roi_align_ml_backward_kernel) "
           "does not have a deterministic implementation, but you set "
           "'torch.use_deterministic_algorithms(True)'. You can turn off determinism "
           "just for this operation, or use the 'warn_only=True' option.")
    if torch.is_deterministic_algorithms_warn_only_enabled():
        warnings.warn(msg)
    else:
        raise RuntimeError(msg)


class _TrainPooler(torch.autograd.Function):
    """Kernel forward on the EXTENDED level list (the caller appended the
    virtual level, so autograd carries its gradient back through the 2x
    average pool); kernel backward w.r.t. the levels; boxes and batch index
    get no gradient. The map is linear in the levels, so the backward needs
    no residual but the routing."""

    @staticmethod
    def forward(ctx, boxes, batch_idx, s, r, strides_ext, cbs, cl, *levels):
        a = _prepare_ext(levels, boxes, batch_idx, s, r, strides_ext, cbs, cl,
                         torch.float32)
        ctx.save_for_backward(a.roi_i, a.roi_f)
        ctx.meta = (s, r, [tuple(f.shape) for f in levels], levels[0].dtype)
        return launch(a)

    @staticmethod
    def backward(ctx, g):
        check_deterministic_backward()
        roi_i, roi_f = ctx.saved_tensors
        s, r, shapes, dtype = ctx.meta
        grads = multilevel_roi_align_backward(
            prepare_backward(g, roi_i, roi_f, shapes, s, r))
        return (None,) * 7 + tuple(t.to(dtype) for t in grads)


def multilevel_roi_align_train(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    batch_idx: torch.Tensor,
    output_size: int,
    strides: Sequence[int],
    sampling_ratio: int = 2,
    canonical_box_size: float = 224.0,
    canonical_level: int = 4,
) -> torch.Tensor:
    """Differentiable pooler for training -> f32 (R, s, s, C).

    CPU tensors take the twin under autograd. CUDA tensors launch the
    forward kernel and, in the backward pass, the backward kernel; any input
    the kernels do not take raises."""
    if boxes.device.type == "cpu":
        return multilevel_roi_align_ref(
            features, boxes, batch_idx, output_size, strides, sampling_ratio,
            canonical_box_size, canonical_level)
    if sampling_ratio <= 0:
        sampling_ratio = 2
    _check_inputs(features, boxes, batch_idx, output_size, sampling_ratio,
                  torch.float32)
    feats, strides_ext = _append_virtual_level(features, tuple(strides))
    return _TrainPooler.apply(boxes, batch_idx, output_size, sampling_ratio,
                              strides_ext, canonical_box_size, canonical_level,
                              *feats)
