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

``multilevel_roi_align_kernel`` is the wrapper: one call of the registered op
``torch.ops.u2seg_torch.multilevel_roi_align``, whose CPU implementation is the
twin and whose CUDA implementation launches ``csrc/roi_align_ml.cu`` or raises
(there is no fallback between them). The launches are counted in
``multilevel_roi_align_kernel.launches``. The op has a fake implementation, so
``torch.export`` keeps it as one node, and a FLOP formula (the twin's count)
for ``torch.utils.flop_counter``.

``multilevel_roi_align_train`` is the differentiable pooler of the train
path (``multilevel_roi_align_train`` of the JAX package): f32 out, gradient
w.r.t. the levels only. On CUDA tensors it is a ``torch.autograd.Function``
whose forward is the kernel above and whose backward is K3, six launches of
the same source (the port of the TPU kernel ``_ml_bwd_kernel``), counted
once per call in ``multilevel_roi_align_backward.launches``; on CPU tensors
it is the twin under autograd, which is also the backward kernel's plain
version. The backward kernel sums every gradient cell's ROIs in ascending
ROI index, in segments of ``SEGMENT`` ROIs whose sums are then added in
order, where the Pallas kernel adds ROI after ROI in grid order: either way
two runs give the same bits, and it runs under
``torch.use_deterministic_algorithms(True)``. ``ordered_backward_reference``
renders its algorithm in plain PyTorch (the tests hold it against the JAX
package).

The kernels' design (the source's header has the detail). For one ROI the
pooled output is ``einsum(Wy, Wx, window)`` with the dense per-axis weights of
``_pooled_axis_weights_host`` (``dense_axis_weights`` below returns them per
ROI), and the backward is its transpose. Every cell of non-zero weight lies
inside the ROI's window and inside the true level dims; the box of those cells
is the ROI's *span* (``roi_spans``). One block serves one (ROI, chunk of
``CHUNK`` = 64 channels): the forward copies the rows of the span that a group
of output rows needs into a buffer in shared memory (block size and buffer
from ``forward_plan``) with 16-byte copies and interpolates from there. The
backward is a gather over tiles of ``BACKWARD_TILE`` x ``BACKWARD_TILE``
cells of a gradient level and image: a routing launch stores each ROI's
tables, a counting sort lists the ROIs that touch each tile, a plan cuts
the lists into segments, heaviest first (``backward_routing`` is the plain
version of all three), a persistent grid adds each segment's ROIs one after
another into registers, and a fold adds a cut tile's segments (no zero fill,
and no atomic decides a value). Both are bound by bytes on the card. That
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
from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.utils.flop_counter

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


BACKWARD_TILE = 8                 # cells per side of a backward tile (kTile)
SEGMENT = 16                      # ROIs of a tile list per work item (kSegment)
STAGES = 3                        # the gather's ring of slots (kStages)
RING_BYTES = 55296                # its slots together (kRingBytes)
PAIR_BITS = 34                    # a list entry's low bits: the pair's geometry
BOX_BINS = 8                      # bins of a row per tensor copy (kBoxBins)


def backward_slots() -> int:
    """List-entry slots per ROI: the most tiles a span can meet (slots_of)."""
    return ((WIN_Y - 1) // BACKWARD_TILE + 2) * ((WIN - 1) // BACKWARD_TILE + 2)


def record_bytes(s: int) -> int:
    """One ROI's tables as the routing pass stores them, 16-byte rounded."""
    return (table_bytes(s) + 15) // 16 * 16


def _round_up(n: int, k: int) -> int:
    return (n + k - 1) // k * k


def slot_bins(s: int) -> int:
    """Bins of f32 cotangent (``CHUNK`` channels each) one slot of the
    gather's ring holds, in whole boxes of ``BOX_BINS`` (a tensor copy's row
    of bins): what ``RING_BYTES / STAGES`` leaves after the 128-byte
    aligned record, at least one row of s bins, at most all s rows."""
    row = _round_up(s, BOX_BINS)
    fit = (RING_BYTES // STAGES - _round_up(record_bytes(s), 128)) // (CHUNK * 4)
    return min(row * s, max(row, fit // BOX_BINS * BOX_BINS))


def backward_shared_bytes(s: int) -> int:
    """Dynamic shared memory of one gather block: per slot of its ring of
    ``STAGES``, two mbarriers (16 bytes) and a header (32), rounded up to
    128 bytes, then the slots, each a ROI's record (128-byte aligned) +
    ``slot_bins(s)`` bins of its f32 cotangent."""
    return (_round_up(STAGES * 48, 128)
            + STAGES * (_round_up(record_bytes(s), 128) + slot_bins(s) * CHUNK * 4))


def backward_bounds(n_roi: int, n_tiles: int) -> Tuple[int, int, int]:
    """What the plan can need at most, known without a look at the data
    (each ROI meets at most ``backward_slots()`` tiles, so the lists hold at
    most P = R * slots pairs): work items (one per tile + one per further
    segment), partial slots (segments after the first of a cut tile) and
    folds (tiles cut into segments)."""
    pairs = n_roi * backward_slots()
    return (n_tiles + pairs // SEGMENT, pairs // SEGMENT,
            min(n_tiles, pairs // (SEGMENT + 1)))


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

    One call of the registered op ``torch.ops.u2seg_torch.multilevel_roi_align``:
    CPU tensors take the plain twin, CUDA tensors launch the kernel; any
    input the kernel does not take raises."""
    if sampling_ratio <= 0:
        sampling_ratio = 2
    return torch.ops.u2seg_torch.multilevel_roi_align(
        list(features), boxes, batch_idx, int(output_size),
        [int(v) for v in strides], int(sampling_ratio), float(canonical_box_size),
        int(canonical_level), out_dtype or torch.float32)


@torch.library.custom_op("u2seg_torch::multilevel_roi_align", mutates_args=(),
                         device_types="cpu")
def _multilevel_roi_align_op(
    features: List[torch.Tensor], boxes: torch.Tensor, batch_idx: torch.Tensor,
    output_size: int, strides: List[int], sampling_ratio: int,
    canonical_box_size: float, canonical_level: int, out_dtype: torch.dtype,
) -> torch.Tensor:
    """The registered K1 op. Its CPU implementation is the plain twin; its
    CUDA one (below) launches the kernel; ``torch.export`` records it as one
    node of the graph (the fake implementation gives its shape)."""
    return multilevel_roi_align_ref(
        features, boxes, batch_idx, output_size, strides, sampling_ratio,
        canonical_box_size, canonical_level).to(out_dtype)


@_multilevel_roi_align_op.register_kernel("cuda")
def _(features, boxes, batch_idx, output_size, strides, sampling_ratio,
      canonical_box_size, canonical_level, out_dtype):
    s, r = output_size, sampling_ratio
    _check_inputs(features, boxes, batch_idx, s, r, out_dtype)
    return launch(prepare_launch(features, boxes, batch_idx, s, r, strides,
                                 canonical_box_size, canonical_level, out_dtype))


@_multilevel_roi_align_op.register_fake
def _(features, boxes, batch_idx, output_size, strides, sampling_ratio,
      canonical_box_size, canonical_level, out_dtype):
    c = features[0].shape[-1]
    return boxes.new_empty((boxes.shape[0], output_size, output_size, c),
                           dtype=out_dtype)


def twin_flops(n_roi: int, channels: int, s: int, r: int) -> int:
    """Multiply-adds x 2 of the plain twin: the two separable contractions of
    the (WIN_Y, WIN) window, ``einsum(Wy, window)`` then ``einsum(Wx, .)``
    over n = s * r samples per axis."""
    n = s * r
    return 2 * n_roi * channels * n * WIN * (WIN_Y + n)


@torch.utils.flop_counter.register_flop_formula(
    torch.ops.u2seg_torch.multilevel_roi_align)
def _flop_formula(features_shape, boxes_shape, batch_idx_shape, output_size,
                  strides, sampling_ratio, *args, out_shape=None, **kwargs) -> int:
    return twin_flops(boxes_shape[0], features_shape[0][-1], output_size,
                      sampling_ratio)


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
def _route_fn():
    return _c_fn("u2seg_roi_align_ml_backward_route",
                 [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4)


@functools.lru_cache(maxsize=None)
def _lists_fn():
    return _c_fn("u2seg_roi_align_ml_backward_lists",
                 [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                 + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5)


@functools.lru_cache(maxsize=None)
def _plan_fn():
    return _c_fn("u2seg_roi_align_ml_backward_plan",
                 [ctypes.c_void_p] + [ctypes.c_int] + [ctypes.c_void_p] * 5)


@functools.lru_cache(maxsize=None)
def _backward_fn():
    return _c_fn("u2seg_roi_align_ml_backward",
                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _fold_fn():
    return _c_fn("u2seg_roi_align_ml_backward_fold",
                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def kernel_shared_bytes(backward: bool, s: int) -> int:
    """What the built library itself says one block takes (builds it)."""
    _, fn = _c_fn("u2seg_roi_align_ml_smem_bytes", [ctypes.c_int] * 5)
    return fn(int(backward), s, WIN_Y, WIN, forward_plan(s)[1])


def kernel_backward_layout(s: int) -> Tuple[int, ...]:
    """What the built library says of the backward (builds it): the tile
    side in cells, the list-entry slots per ROI, the bytes of a ROI's record,
    the ROIs of a segment, the ring's slots, the bins a slot holds and a
    list entry's pair bits."""
    lib = _cuda.load("roi_align_ml")
    fn = lib.u2seg_roi_align_ml_backward_layout
    fn.restype = None
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = (ctypes.c_int * 7)()
    fn(s, WIN_Y, WIN, ctypes.cast(out, ctypes.c_void_p))
    return tuple(out)


def backward_layout(s: int) -> Tuple[int, ...]:
    """The same seven numbers as the wrapper plans them."""
    return (BACKWARD_TILE, backward_slots(), record_bytes(s), SEGMENT, STAGES,
            slot_bins(s), PAIR_BITS)


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
    """Everything one backward call reads and writes."""
    g: torch.Tensor              # (R, s, s, C) f32 contiguous cotangent
    roi_i: torch.Tensor          # as LaunchArgs
    roi_f: torch.Tensor
    grads: List[torch.Tensor]    # f32 (B, H_l, W_l, C) per extended level
    records: torch.Tensor        # (R, record_bytes(s)) uint8: the ROIs' tables
    spans: torch.Tensor          # (R, 4) int32: each ROI's span in tiles
    words: torch.Tensor          # (R, backward_slots()) int64: its list entries
    tile_count: torch.Tensor     # (tiles,) int32: the ROIs of each tile
    tile_start: torch.Tensor     # (tiles + 1,) int32: each tile's first list entry
    lists: torch.Tensor          # (bound,) int64: the tiles' lists, one after another
    items: torch.Tensor          # (bound, 4) int32: tile, first entry, ROIs, partial slot
    folds: torch.Tensor          # (bound, 4) int32: tile, first partial slot, partials, 0
    counts: torch.Tensor         # (3,) int32: items, folds, the gather's next work
    partials: torch.Tensor       # (bound, 64, C) f32: segments 1, 2, ... of cut tiles
    s: int
    r: int


def backward_tiles(shapes) -> Tuple[List[Tuple[int, int]], List[int]]:
    """Tile rows and columns per extended level, and each level's first tile
    id (a last entry: the tile count). Tiles are numbered by level, then
    image, then tile row and column, as the kernel decodes its block index."""
    t = BACKWARD_TILE
    tiles = [((h + t - 1) // t, (w + t - 1) // t) for _, h, w, _ in shapes]
    firsts = [0, *itertools.accumulate(shapes[0][0] * ty * tx for ty, tx in tiles)]
    return tiles, firsts


class SegmentPlan(NamedTuple):
    """The gather's work: ``items`` (N, 4) int64 rows (tile, first list
    position, ROIs, partial slot) in the order the grid takes them, and
    ``folds`` (F, 3) rows (tile, first partial slot, partials)."""
    items: torch.Tensor
    folds: torch.Tensor


def segment_plan(tile_start, segment: int = SEGMENT) -> SegmentPlan:
    """The plain version of the plan launch. Every tile's list is cut into
    segments of ``segment`` consecutive ROIs (an empty list: one segment of
    none); the items, one per segment, come in descending ROI count, ties by
    tile, then segment. Segment 0 of a tile stores into the gradient level
    (slot -1); segment k >= 1 of a tile cut into n stores into partial slot
    ``first + k - 1``, the tiles' slots numbered in tile order; a fold adds
    them, in segment order, into what segment 0 stored."""
    starts = [int(v) for v in tile_start.tolist()]
    segs, folds, slot = [], [], 0
    for t, (a, b) in enumerate(zip(starts, starts[1:])):
        n = b - a
        cut = max(1, -(-n // segment))
        for k in range(cut):
            segs.append((min(segment, n - k * segment), t, k, a + k * segment,
                         slot + k - 1 if k else -1))
        if cut > 1:
            folds.append((t, slot, cut - 1))
            slot += cut - 1
    segs.sort(key=lambda e: (-e[0], e[1], e[2]))
    items = [(t, first, count, part) for count, t, _, first, part in segs]
    return SegmentPlan(torch.tensor(items, dtype=torch.int64).reshape(-1, 4),
                       torch.tensor(folds, dtype=torch.int64).reshape(-1, 3))


def backward_routing(roi_i, roi_f, shapes, s, r, segment: int = SEGMENT):
    """The plain version of the backward's routing (its routing, count, plan
    and fill launches), torch ops that run under
    ``torch.use_deterministic_algorithms(True)``: ``tile_start`` (tiles + 1,)
    int32, ``tile_rois`` (P,) int32, where the ROIs of tile t are
    ``tile_rois[tile_start[t]:tile_start[t + 1]]`` in ascending index: those
    whose span, widened by one cell on each side, meets the tile on the ROI's
    level and image; and the ``segment_plan`` of those lists. The kernel
    takes the span of its own tables; this one takes ``roi_spans`` of torch's
    f32 weights, and the widening covers a last-bit difference between the
    two (the kernel contracts ``c0 + rel * bin`` into one FMA). A ROI listed
    for a tile that its exact span misses adds nothing there.

    Every ROI gets a fixed number of slots (the most tiles a window widened
    by one cell can meet), so the sort has a size known without a sync;
    unused slots sort last."""
    dev = roi_i.device
    n = roi_i.shape[0]
    t = BACKWARD_TILE
    tiles, firsts = backward_tiles(shapes)
    n_tiles = firsts[-1]
    if n == 0:
        starts = torch.zeros(n_tiles + 1, dtype=torch.int32, device=dev)
        return starts, torch.zeros(0, dtype=torch.int32, device=dev), segment_plan(
            starts, segment)
    lvl = roi_i[:, 0].long()
    oy, ox, b = roi_i[:, 1].long(), roi_i[:, 2].long(), roi_i[:, 3].long()
    h = device_table([sh[1] for sh in shapes], torch.int64, dev)[lvl]
    w = device_table([sh[2] for sh in shapes], torch.int64, dev)[lvl]
    wy = _pooled_axis_weights_host(roi_f[:, 0], roi_f[:, 2], oy, h.float(), s, r, WIN_Y)
    wx = _pooled_axis_weights_host(roi_f[:, 1], roi_f[:, 3], ox, w.float(), s, r, WIN)
    sp = roi_spans(wy, wx)
    live = (sp[:, 0] <= sp[:, 1]) & (sp[:, 2] <= sp[:, 3])
    y_lo = torch.clamp(sp[:, 0] + oy - 1, min=0) // t
    y_hi = torch.minimum(sp[:, 1] + oy + 1, h - 1) // t
    x_lo = torch.clamp(sp[:, 2] + ox - 1, min=0) // t
    x_hi = torch.minimum(sp[:, 3] + ox + 1, w - 1) // t
    ty = y_lo[:, None] + torch.arange((WIN_Y + 1) // t + 2, device=dev)
    tx = x_lo[:, None] + torch.arange((WIN + 1) // t + 2, device=dev)
    ok = (live[:, None, None] & (ty <= y_hi[:, None])[:, :, None]
          & (tx <= x_hi[:, None])[:, None, :])
    rows = device_table([v for v, _ in tiles], torch.int64, dev)[lvl]
    cols = device_table([v for _, v in tiles], torch.int64, dev)[lvl]
    first = device_table(firsts[:-1], torch.int64, dev)[lvl]
    tile = (first[:, None, None] + ((b * rows)[:, None, None] + ty[:, :, None])
            * cols[:, None, None] + tx[:, None, :])
    roi = torch.arange(n, device=dev)[:, None, None]
    keys = torch.where(ok, tile * n + roi, n_tiles * n).flatten()
    keys = torch.sort(keys).values
    starts = torch.searchsorted(keys, torch.arange(n_tiles + 1, device=dev) * n)
    starts = starts.to(torch.int32)
    return starts, (keys % n).to(torch.int32), segment_plan(starts, segment)


def _tile_box(k, tiles, firsts, shapes):
    """Level, image and the cell box [y0, y1) x [x0, x1) of tile k."""
    level = max(i for i, f in enumerate(firsts[:-1]) if f <= k)
    rows, cols = tiles[level]
    b, rest = divmod(k - firsts[level], rows * cols)
    y0, x0 = rest // cols * BACKWARD_TILE, rest % cols * BACKWARD_TILE
    return (level, b, y0, min(y0 + BACKWARD_TILE, shapes[level][1]), x0,
            min(x0 + BACKWARD_TILE, shapes[level][2]))


def ordered_backward_reference(g, roi_i, roi_f, shapes, s, r, segment: int = SEGMENT,
                               routing=None) -> List[torch.Tensor]:
    """K3's algorithm in plain PyTorch, for the tests: the routing lists of
    ``backward_routing`` (or ``routing``, a pair ``tile_start``,
    ``tile_rois`` of lists to follow instead, such as the kernel's own) and
    their ``segment_plan``; every work item adds the window
    cotangents ``Wy^T g Wx`` (the dense weights of
    ``_pooled_axis_weights_host``) of its segment's ROIs, in order, over its
    tile's cells into a sum that starts at zero and stores it (segment 0
    into the gradient, the others into partial slots); each fold then adds a
    cut tile's partials, in segment order, to what segment 0 stored. f32
    gradients at the true dims of the extended levels."""
    if routing is None:
        starts, rois, plan = backward_routing(roi_i, roi_f, shapes, s, r, segment)
    else:
        starts, rois = routing
        plan = segment_plan(starts, segment)
    rois = rois.tolist()
    lvl = roi_i[:, 0].long()
    h = device_table([sh[1] for sh in shapes], torch.float32, g.device)[lvl]
    w = device_table([sh[2] for sh in shapes], torch.float32, g.device)[lvl]
    wy = _pooled_axis_weights_host(roi_f[:, 0], roi_f[:, 2], roi_i[:, 1], h, s, r, WIN_Y)
    wx = _pooled_axis_weights_host(roi_f[:, 1], roi_f[:, 3], roi_i[:, 2], w, s, r, WIN)
    g = g.to(torch.float32)
    gwin = torch.einsum("rpy,rpqc,rqx->ryxc", wy, g, wx)   # (R, WIN_Y, WIN, C)
    grads = [torch.zeros(sh, dtype=torch.float32, device=g.device) for sh in shapes]
    tiles, firsts = backward_tiles(shapes)
    origins = roi_i[:, 1:3].tolist()
    partials = {}
    for k, first, count, slot in plan.items.tolist():
        level, b, y0, y1, x0, x1 = _tile_box(k, tiles, firsts, shapes)
        acc = torch.zeros(y1 - y0, x1 - x0, g.shape[-1], device=g.device)
        for roi in rois[first:first + count]:
            oy, ox = origins[roi]
            # the tile's cells inside the ROI's window
            ya, yb = max(y0, oy), min(y1, oy + WIN_Y)
            xa, xb = max(x0, ox), min(x1, ox + WIN)
            if ya < yb and xa < xb:
                acc[ya - y0:yb - y0, xa - x0:xb - x0] += gwin[roi, ya - oy:yb - oy,
                                                             xa - ox:xb - ox]
        if slot < 0:
            grads[level][b, y0:y1, x0:x1] = acc
        else:
            partials[slot] = acc
    for k, first, n in plan.folds.tolist():
        level, b, y0, y1, x0, x1 = _tile_box(k, tiles, firsts, shapes)
        for slot in range(first, first + n):
            grads[level][b, y0:y1, x0:x1] += partials[slot]
    return grads


def prepare_backward(g, roi_i, roi_f, shapes, s, r) -> BackwardArgs:
    """Bring the cotangent to contiguous f32 and allocate what the kernels
    write (``torch.empty``, sized by ``backward_bounds``, no sync): the f32
    gradient levels at their true dims (every element is written), the ROIs'
    records, spans and list entries, the tiles' counts, starts and lists,
    the plan and the partial sums of cut tiles."""
    if g.device.type != "cuda" or g.shape != (roi_i.shape[0], s, s, shapes[0][3]):
        raise ValueError("cotangent must be a CUDA tensor of shape (R, s, s, C)")
    g = g.to(torch.float32).contiguous()
    dev = g.device
    grads = [torch.empty(sh, dtype=torch.float32, device=dev) for sh in shapes]
    n = roi_i.shape[0]
    if n >= 1 << (63 - PAIR_BITS):
        raise ValueError(f"{n} ROIs: a list entry holds fewer than 2^{63 - PAIR_BITS}")
    n_tiles = backward_tiles(shapes)[1][-1]
    n_items, n_partials, n_folds = backward_bounds(n, n_tiles)
    empty = functools.partial(torch.empty, device=dev)
    records = empty((n, record_bytes(s)), dtype=torch.uint8)
    spans = empty((n, 4), dtype=torch.int32)
    words = empty((n, backward_slots()), dtype=torch.int64)
    tile_count = empty(n_tiles, dtype=torch.int32)
    tile_start = empty(n_tiles + 1, dtype=torch.int32)
    lists = empty(max(1, n * backward_slots()), dtype=torch.int64)
    items = empty((n_items, 4), dtype=torch.int32)
    folds = empty((max(1, n_folds), 4), dtype=torch.int32)
    counts = empty(3, dtype=torch.int32)
    partials = empty((max(1, n_partials), BACKWARD_TILE ** 2, shapes[0][3]),
                     dtype=torch.float32)
    check_aligned([g, *grads, records, spans, words, lists, items, folds, partials],
                  "cotangent, gradient and routing")
    return BackwardArgs(g, roi_i, roi_f, grads, records, spans, words, tile_count,
                        tile_start, lists, items, folds, counts, partials, s, r)


def backward_steps(a: BackwardArgs):
    """The launches of one K3 call in order, as (name, function of no
    arguments) on the current stream: the routing launch (each ROI's record,
    span and list entries), the count launch (the ROIs of each tile), the
    plan launch (list starts, work items, folds), the fill launch (the
    tiles' lists, ROIs in ascending index), the gather launch and the fold
    launch. Each may be run alone once the ones before it have run."""
    n_roi, _, _, c = a.g.shape
    check_launch_plan(a.s, a.r, c, backward_shared_bytes(a.s))
    shapes = [tuple(t.shape) for t in a.grads]
    n_tiles = backward_tiles(shapes)[1][-1]
    ptrs, hs, ws, _ = _level_tables(a.grads)       # the casts keep their arrays
    nl, batch = len(shapes), shapes[0][0]
    stream = lambda: torch.cuda.current_stream(a.g.device).cuda_stream  # noqa: E731

    def route():
        if n_roi:
            lib, fn = _route_fn()
            _cuda.check(lib, fn(hs, ws, nl, batch, a.roi_i.data_ptr(), a.roi_f.data_ptr(),
                                n_roi, a.s, a.r, WIN_Y, WIN, a.records.data_ptr(),
                                a.spans.data_ptr(), a.words.data_ptr(), stream()),
                        "roi_align_ml backward routing launch")

    def lists(fill):
        lib, fn = _lists_fn()
        _cuda.check(lib, fn(int(fill), hs, ws, nl, batch, n_tiles, a.spans.data_ptr(), n_roi,
                            WIN_Y, WIN, a.tile_count.data_ptr(), a.tile_start.data_ptr(),
                            a.words.data_ptr(), a.lists.data_ptr(), stream()),
                    "roi_align_ml backward list launch")

    def plan():
        lib, fn = _plan_fn()
        _cuda.check(lib, fn(a.tile_count.data_ptr(), n_tiles, a.tile_start.data_ptr(),
                            a.items.data_ptr(), a.folds.data_ptr(), a.counts.data_ptr(),
                            stream()),
                    "roi_align_ml backward plan launch")

    def gather():
        lib, fn = _backward_fn()
        _cuda.check(lib, fn(ptrs, hs, ws, nl, batch, a.records.data_ptr(), a.g.data_ptr(),
                            a.lists.data_ptr(), a.items.data_ptr(), a.counts.data_ptr(),
                            a.partials.data_ptr(), a.items.shape[0], n_tiles, n_roi, c,
                            a.s, WIN_Y, WIN, stream()),
                    "roi_align_ml backward launch")

    def fold():
        lib, fn = _fold_fn()
        _cuda.check(lib, fn(ptrs, hs, ws, nl, batch, a.folds.data_ptr(), a.counts.data_ptr(),
                            a.partials.data_ptr(), a.folds.shape[0], n_tiles, c, stream()),
                    "roi_align_ml backward fold launch")

    return [("route", route), ("count", lambda: lists(False)), ("plan", plan),
            ("fill", lambda: lists(True)), ("gather", gather), ("fold", fold)]


def multilevel_roi_align_backward(a: BackwardArgs) -> List[torch.Tensor]:
    """K3 on the current stream (``backward_steps``): every cell of
    ``a.grads`` gets the sum of its ROIs' cotangents, ROI after ROI in
    ascending index within a segment of ``SEGMENT`` of them, segments in
    order. Counts one launch in ``multilevel_roi_align_backward.launches``."""
    for _, step in backward_steps(a):
        step()
    multilevel_roi_align_backward.launches += 1
    return a.grads


multilevel_roi_align_backward.launches = 0


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
