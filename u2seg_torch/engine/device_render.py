"""Exact full-resolution panoptic render on the device, with an RLE-packed
fetch (counterpart of ``u2seg_tpu/engine/device_render.py``).

The host render (``engine/panoptic_render.py``) needs the 28-channel stride-4
semantic logits and the 100 x 28 x 28 mask logits of every image on the host.
Here the whole chain (mask paste, two-stage semantic resize, argmax, greedy
fusion with sequential segment ids) runs on the device at the original image
resolution, and the host fetches one uint8 buffer per batch that holds

  - the run-length-encoded panoptic id map and semantic argmax map,
  - small per-segment tables (who was painted, scores, classes, areas),
  - the detections' boxes, scores, classes and validity.

Exactness: the semantic chain is composed into per-axis weight matrices and
evaluated as f32 matrix products; mask paste is ``ops/mask_paste.py``; fusion
is the greedy pass in score order. Every f32 product here runs with TF32 off
(``exact_f32_matmul``): an argmax or a 0.5 threshold moves otherwise.
Differences from the float64-coordinate host oracle are confined to
sub-ulp ties (argmax / threshold pixels).

Shapes are fixed by the render canvas (``cfg.test.render_canvas``); the
per-image original size enters as device scalars, so no size is read back
to the host. Images that do not fit the canvas, whose RLE exceeds
``max_runs``, or that have more eligible instances than ``k_fuse`` raise a
per-image fallback flag, and the host renders those exactly.

What differs from the JAX package inside (same outputs):

- ``stuff_ok[sem_lab]`` / ``stuff_id[sem_lab]`` are integer gathers and the
  per-class areas an integer sum of a one-hot comparison, where the JAX code
  multiplies a bf16 one-hot (exact only while ``k_fuse + num_stuff <= 256``);
- the greedy paint is a Python loop of ``k_fuse`` steps whose decision stays
  on the device (no ``.item()``, no boolean indexing): ~5 launches a step;
- ``rle_encode`` compacts run starts with a cumulative sum and one
  ``scatter_`` into a ``max_runs + 1`` buffer whose spare slot takes every
  non-boundary and out-of-budget write: no sort, no ``nonzero``, 0 host
  syncs;
- ``pack_rendered_batch`` scatters into a buffer with one spare slot for the
  dropped writes and cuts it off.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from u2seg_torch.ops.mask_paste import paste_masks


@contextlib.contextmanager
def exact_f32_matmul():
    """f32 matrix products in full f32 on the card (TF32 off) inside."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# Device-side pieces
# ---------------------------------------------------------------------------

def _clamped_axis_weights(coord: torch.Tensor, src_size: int) -> torch.Tensor:
    """(P,) float sample coords -> (P, src_size) 2-tap bilinear weights
    (the coords are already clamped into [0, src_size - 1])."""
    j = torch.arange(src_size, dtype=torch.float32, device=coord.device)
    return torch.clamp(1.0 - torch.abs(coord[:, None] - j[None, :]), min=0.0)


def _resize_coords(out_size: int, src_valid: torch.Tensor,
                   dst_valid: torch.Tensor) -> torch.Tensor:
    """Source coordinate of each of ``out_size`` output cells of a
    ``src_valid -> dst_valid`` resize (half-pixel centres), clamped to the
    valid source border. The extents are 0-dim device tensors."""
    src = src_valid.to(torch.float32)
    scale = src / torch.clamp(dst_valid.to(torch.float32), min=1.0)
    i = torch.arange(out_size, dtype=torch.float32, device=src.device)
    coord = (i + 0.5) * scale - 0.5
    return torch.minimum(torch.clamp(coord, min=0.0),
                         torch.clamp(src - 1.0, min=0.0))


def sem_resize_weights(
    out_size: int,             # canvas extent along this axis
    s4_size: int,              # stride-4 logits extent
    stride: int,
    in_valid: torch.Tensor,    # () int: valid input extent (ih or iw)
    out_valid: torch.Tensor,   # () int: original extent (oh or ow)
) -> torch.Tensor:
    """Composed per-axis weights (out_size, s4_size) of the two-stage
    bilinear chain: stride-s upsample of the s4 logits (border replicate),
    crop to ``in_valid``, resize to ``out_valid``: W = B @ A with A the
    static upsample weights and B the crop+resize weights. Rows >=
    out_valid are garbage and must be masked by the caller."""
    dev = in_valid.device
    up = s4_size * stride
    ca = torch.clamp(
        (torch.arange(up, dtype=torch.float32, device=dev) + 0.5) / stride - 0.5,
        0.0, s4_size - 1.0)
    a = _clamped_axis_weights(ca, s4_size)                       # (up, s4)
    b = _clamped_axis_weights(
        _resize_coords(out_size, in_valid, out_valid), up)       # (out, up)
    with exact_f32_matmul():
        return b @ a                                             # (out, s4)


def resize_image_device(
    raw: torch.Tensor,           # (RH, RW, 3) u8/f32 raw image, zero-padded
    orig_hw: torch.Tensor,       # (2,) int32 valid raw extent
    input_hw: torch.Tensor,      # (2,) int32 resize target (<= canvas)
    canvas: Tuple[int, int],     # network-input bucket (BH, BW)
) -> torch.Tensor:
    """Test-time resize on the device: bilinear with half-pixel centres and
    border replicate, as two weight products. The host counterpart is
    ``ResizeTransform.apply_image`` on a float32 image. Rows and columns
    beyond ``input_hw`` are zero."""
    bh, bw = canvas
    rh, rw = raw.shape[0], raw.shape[1]
    dev = raw.device
    wy = _clamped_axis_weights(
        _resize_coords(bh, orig_hw[0], input_hw[0]), rh)        # (BH, RH)
    wx = _clamped_axis_weights(
        _resize_coords(bw, orig_hw[1], input_hw[1]), rw)        # (BW, RW)
    with exact_f32_matmul():
        rows = wy @ raw.to(torch.float32).reshape(rh, rw * 3)   # (BH, RW*3)
        out = torch.einsum("jq,iqc->ijc", wx, rows.reshape(bh, rw, 3))
    inside = ((torch.arange(bh, device=dev)[:, None] < input_hw[0])
              & (torch.arange(bw, device=dev)[None, :] < input_hw[1]))
    return torch.where(inside[..., None], out, torch.zeros((), device=dev))


def rle_encode(flat: torch.Tensor, max_runs: int):
    """Run-length encode int arrays ``(..., n)`` along their last axis with a
    fixed run budget.

    Returns (starts (..., max_runs) int32, values int32, n_runs (...)
    int32). Runs beyond the budget are dropped (the caller checks ``n_runs
    <= max_runs`` and falls back); entries past ``n_runs`` are 0. Decoding:
    run r covers [starts[r], starts[r+1]) with value values[r]; the last run
    ends at n."""
    n = flat.shape[-1]
    lead = flat.shape[:-1]
    dev = flat.device
    boundary = torch.cat([
        torch.ones(lead + (1,), dtype=torch.bool, device=dev),
        flat[..., 1:] != flat[..., :-1]], dim=-1)                 # (..., n)
    rank = torch.cumsum(boundary, dim=-1) - 1                     # run id
    n_runs = (rank[..., -1] + 1).to(torch.int32)
    # boundary positions go to their run's slot; everything else, and runs
    # past the budget, to the spare slot that is cut off below
    dest = torch.where(boundary & (rank < max_runs), rank,
                       torch.full_like(rank, max_runs))
    pos = torch.arange(n, dtype=torch.int32, device=dev).expand(lead + (n,))
    starts = torch.zeros(lead + (max_runs + 1,), dtype=torch.int32, device=dev)
    starts = starts.scatter_(-1, dest, pos)[..., :max_runs]
    ok = (torch.arange(max_runs, device=dev)
          < torch.clamp(n_runs, max=max_runs)[..., None])
    starts = torch.where(ok, starts, torch.zeros_like(starts))
    values = torch.gather(flat, -1, starts.long()).to(torch.int32)
    values = torch.where(ok, values, torch.zeros_like(values))
    return starts, values, n_runs


@dataclasses.dataclass
class RenderedImage:
    """Compact device render of one image, or of a batch with a leading
    batch axis on every field."""
    pan_starts: torch.Tensor       # (R,) int32
    pan_values: torch.Tensor       # (R,) int32
    pan_nruns: torch.Tensor        # () int32
    sem_starts: torch.Tensor       # (R,) int32
    sem_values: torch.Tensor       # (R,) int32
    sem_nruns: torch.Tensor        # () int32
    takes: torch.Tensor            # (Kf,) bool: painted, in sorted order
    order: torch.Tensor            # (Kf,) int32: det slot per sorted rank
    sorted_scores: torch.Tensor    # (Kf,)
    sorted_classes: torch.Tensor   # (Kf,) int32
    stuff_ok: torch.Tensor         # (C,) bool
    stuff_area: torch.Tensor       # (C,) int32
    fallback: torch.Tensor         # () bool: the host must re-render exactly


def _render_maps(
    boxes: torch.Tensor,          # (K, 4) XYXY network-input coords
    scores: torch.Tensor,         # (K,)
    classes: torch.Tensor,        # (K,) int32
    valid: torch.Tensor,          # (K,) bool
    mask_logits: torch.Tensor,    # (K, M, M)
    sem_logits: torch.Tensor,     # (H4, W4, C) stride-4, padded
    input_hw: torch.Tensor,       # (2,) int32 valid network-input size
    orig_hw: torch.Tensor,        # (2,) int32 original size
    *,
    canvas: Tuple[int, int],
    k_fuse: int,
    stride: int = 4,
    instance_conf_thresh: float = 0.5,
    overlap_thresh: float = 0.5,
    stuff_area_limit: int = 4096,
):
    """Exact full-res render of one image on the device: (pan (OH, OW) i32,
    sem_lab (OH, OW) i32, per-segment meta dict)."""
    oh_c, ow_c = canvas
    h4, w4, num_stuff = sem_logits.shape
    dev = sem_logits.device
    k = boxes.shape[0]
    k_fuse = min(k_fuse, k)
    ih, iw = input_hw[0], input_hw[1]
    oh, ow = orig_hw[0], orig_hw[1]

    yy = torch.arange(oh_c, dtype=torch.int32, device=dev)[:, None]
    xx = torch.arange(ow_c, dtype=torch.int32, device=dev)[None, :]
    inside = (yy < oh) & (xx < ow)                               # (OH, OW)

    # ---- semantic: composed two-stage bilinear + argmax -----------------
    # two plain 2-D products (x, then y) with the class axis folded into
    # the rows
    wy = sem_resize_weights(oh_c, h4, stride, ih, oh)            # (OH, H4)
    wx = sem_resize_weights(ow_c, w4, stride, iw, ow)            # (OW, W4)
    s_pc_q = sem_logits.to(torch.float32).permute(0, 2, 1)       # (H4, C, W4)
    with exact_f32_matmul():
        t = s_pc_q.reshape(h4 * num_stuff, w4) @ wx.T            # (H4*C, OW)
        sem_full = (wy @ t.reshape(h4, num_stuff * ow_c)).reshape(
            oh_c, num_stuff, ow_c)                               # (OH, C, OW)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    sem_lab = torch.where(
        inside, torch.argmax(sem_full, dim=1).to(torch.int32), zero)

    # ---- instances: sort, truncate to the fusion budget ------------------
    masked = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    ordr = torch.sort(-masked, stable=True)[1][:k_fuse]
    sscores = scores[ordr]
    sclasses = classes[ordr].to(torch.int32)
    svalid = valid[ordr]

    # boxes -> original-resolution coords
    sx = ow.to(torch.float32) / iw.to(torch.float32)
    sy = oh.to(torch.float32) / ih.to(torch.float32)
    owf, ohf = ow.to(torch.float32), oh.to(torch.float32)
    sb = boxes[ordr].to(torch.float32) * torch.stack([sx, sy, sx, sy])
    sb = torch.minimum(torch.clamp(sb, min=0.0),
                       torch.stack([owf, ohf, owf, ohf])[None, :])

    with exact_f32_matmul():
        masks_full = paste_masks(
            torch.sigmoid(mask_logits[ordr].to(torch.float32)), sb,
            oh_c, ow_c) >= 0.5
    masks_full = masks_full & inside[None]

    area = masks_full.sum(dim=(1, 2))                            # (Kf,)
    eligible = svalid & (sscores >= instance_conf_thresh) & (area > 0)

    # greedy paint in score order: instance i is painted iff its overlap
    # with the union of earlier-painted masks is <= overlap_thresh. The
    # decision stays on the device; only the claimed bitmap is carried.
    claimed = torch.zeros((oh_c, ow_c), dtype=torch.bool, device=dev)
    take_list = []
    area_f = torch.clamp(area, min=1)
    for i in range(k_fuse):
        inter = (masks_full[i] & claimed).sum()
        take = eligible[i] & (inter / area_f[i] <= overlap_thresh)
        claimed = claimed | (masks_full[i] & take)
        take_list.append(take)
    takes = (torch.stack(take_list) if k_fuse
             else torch.zeros((0,), dtype=torch.bool, device=dev))
    # first-taken-wins winner with sequential paint-order ids: ``seq`` is
    # nondecreasing, so the first taking mask's id is the min of ``seq``
    # over the taking masks at that pixel
    seq = torch.cumsum(takes, dim=0).to(torch.int32)             # 1-based
    n_inst = seq[-1] if k_fuse else zero
    if k_fuse:
        first = torch.where(
            masks_full & takes[:, None, None], seq[:, None, None],
            torch.full((), k_fuse + 1, dtype=torch.int32, device=dev)
        ).amin(dim=0)
        inst_id_map = torch.where(claimed, first, zero)
    else:
        inst_id_map = torch.zeros((oh_c, ow_c), dtype=torch.int32, device=dev)

    # ---- stuff fill -------------------------------------------------------
    stuff_mask = (~claimed) & (sem_lab > 0) & inside
    labels = torch.arange(num_stuff, dtype=torch.int32, device=dev)
    stuff_area = ((sem_lab[..., None] == labels) & stuff_mask[..., None]).sum(
        dim=(0, 1)).to(torch.int32)                              # (C,)
    stuff_ok = (stuff_area >= stuff_area_limit) & (labels > 0)
    # sequential stuff ids after the instances, ascending label order
    stuff_id = n_inst + torch.cumsum(stuff_ok, dim=0).to(torch.int32)
    lab = sem_lab.long()
    lab_ok = stuff_ok[lab] & stuff_mask
    stuff_id_map = torch.where(lab_ok, stuff_id[lab], zero)

    pan = torch.where(inside, inst_id_map + stuff_id_map, zero)

    n_eligible_all = (valid & (scores >= instance_conf_thresh)).sum()
    fallback = (oh > oh_c) | (ow > ow_c) | (n_eligible_all > k_fuse)
    return pan, sem_lab, dict(
        takes=takes, order=ordr.to(torch.int32), sorted_scores=sscores,
        sorted_classes=sclasses, stuff_ok=stuff_ok, stuff_area=stuff_area,
        fallback=fallback,
    )


def _encode_rendered(pan, sem_lab, meta, max_runs: int) -> RenderedImage:
    """RLE-encode rendered maps ``(..., OH, OW)`` and assemble the fetch
    struct (leading axes are kept on every field)."""
    pan_s, pan_v, pan_n = rle_encode(pan.flatten(-2), max_runs)
    sem_s, sem_v, sem_n = rle_encode(sem_lab.flatten(-2), max_runs)
    fallback = meta["fallback"] | (pan_n > max_runs) | (sem_n > max_runs)
    return RenderedImage(
        pan_starts=pan_s, pan_values=pan_v, pan_nruns=pan_n,
        sem_starts=sem_s, sem_values=sem_v, sem_nruns=sem_n,
        takes=meta["takes"], order=meta["order"],
        sorted_scores=meta["sorted_scores"],
        sorted_classes=meta["sorted_classes"], stuff_ok=meta["stuff_ok"],
        stuff_area=meta["stuff_area"], fallback=fallback,
    )


def render_image(*args, max_runs: int, **kw) -> RenderedImage:
    """Exact full-res render + RLE pack of one image (see _render_maps)."""
    pan, sem_lab, meta = _render_maps(*args, **kw)
    return _encode_rendered(pan, sem_lab, meta, max_runs)


def render_batch(
    det,                          # Detections, batched (B, ...)
    sem_logits: torch.Tensor,     # (B, H4, W4, C)
    image_sizes: torch.Tensor,    # (B, 2)
    orig_sizes: torch.Tensor,     # (B, 2)
    max_runs: int = 16384,
    **kw,
) -> RenderedImage:
    """Batch render, one image after another (the paste and fusion canvases
    of one image are the peak; they are freed before the next), then one
    batched RLE encode of the stacked maps."""
    maps = [
        _render_maps(det.boxes[i], det.scores[i], det.classes[i],
                     det.valid[i], det.mask_logits[i], sem_logits[i],
                     image_sizes[i], orig_sizes[i], **kw)
        for i in range(sem_logits.shape[0])
    ]
    pan = torch.stack([m[0] for m in maps])
    sem_lab = torch.stack([m[1] for m in maps])
    meta = {k: torch.stack([m[2][k] for m in maps]) for k in maps[0][2]}
    return _encode_rendered(pan, sem_lab, meta, max_runs)


@dataclasses.dataclass
class PackedRender:
    """Batch render with the RLE buffers compacted for a prefix fetch.

    ``render_batch`` returns fixed (B, max_runs) run buffers, mostly zero
    padding. Here the batch's used runs sit in ONE shared buffer (pan then
    sem, per image, in batch order), so the host needs ``offs`` and the
    first ``offs[-1]`` entries of ``starts`` / ``values``. Run values fit
    int16 (segment ids are bounded by k_fuse + num_stuff)."""
    starts: torch.Tensor           # (2*B*R,) int32 run starts, compacted
    values: torch.Tensor           # (2*B*R,) int16 run values, compacted
    offs: torch.Tensor             # (2B+1,) int32: image b's pan runs live at
                                   # [offs[2b], offs[2b+1]), sem at
                                   # [offs[2b+1], offs[2b+2])
    starts_prefix: torch.Tensor    # (P,) fixed prefix of ``starts``, fetched
                                   # with every batch
    values_prefix: torch.Tensor    # (P,) int16 prefix of ``values``
    takes: torch.Tensor            # (B, Kf) bool
    order: torch.Tensor            # (B, Kf) int32
    sorted_scores: torch.Tensor    # (B, Kf)
    sorted_classes: torch.Tensor   # (B, Kf) int32
    stuff_ok: torch.Tensor         # (B, C) bool
    stuff_area: torch.Tensor       # (B, C) int32
    fallback: torch.Tensor         # (B,) bool


def pack_rendered_batch(r: RenderedImage, prefix: int = 0) -> PackedRender:
    """Compact a batched ``RenderedImage`` on the device.

    ``prefix`` is the length of the run prefix that rides every fetch
    (``starts_prefix`` / ``values_prefix``); a batch whose total run count
    exceeds it makes the host fetch a slice of the full buffers too."""
    bsz, max_runs = r.pan_starts.shape
    dev = r.pan_starts.device
    n_pan = torch.clamp(r.pan_nruns, max=max_runs).to(torch.int32)
    n_sem = torch.clamp(r.sem_nruns, max=max_runs).to(torch.int32)
    counts = torch.stack([n_pan, n_sem], dim=1).reshape(-1)      # (2B,)
    offs = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=dev),
        torch.cumsum(counts, dim=0).to(torch.int32)])            # (2B+1,)
    buf = 2 * bsz * max_runs
    j = torch.arange(max_runs, dtype=torch.int32, device=dev)[None, :]

    def dest(base, n):
        d = base[:, None] + j
        return torch.where(j < n[:, None], d, torch.full_like(d, buf))

    dd = torch.cat([
        dest(offs[0:2 * bsz:2], n_pan).reshape(-1),
        dest(offs[1:2 * bsz:2], n_sem).reshape(-1),
    ]).long()
    src_s = torch.cat([r.pan_starts.reshape(-1), r.sem_starts.reshape(-1)])
    src_v = torch.cat([r.pan_values.reshape(-1), r.sem_values.reshape(-1)])
    # slot ``buf`` takes every dropped write and is cut off
    starts = torch.zeros((buf + 1,), dtype=torch.int32, device=dev).scatter_(
        0, dd, src_s.to(torch.int32))[:buf]
    values = torch.zeros((buf + 1,), dtype=torch.int16, device=dev).scatter_(
        0, dd, src_v.to(torch.int16))[:buf]
    p = min(max(int(prefix), 0), buf)
    return PackedRender(
        starts=starts, values=values, offs=offs,
        starts_prefix=starts[:p], values_prefix=values[:p],
        takes=r.takes, order=r.order, sorted_scores=r.sorted_scores,
        sorted_classes=r.sorted_classes, stuff_ok=r.stuff_ok,
        stuff_area=r.stuff_area, fallback=r.fallback,
    )


# ---------------------------------------------------------------------------
# Single-buffer fetch
# ---------------------------------------------------------------------------
#
# Everything the host needs in the common case is flattened into ONE
# contiguous uint8 buffer on the device and fetched with ONE device-to-host
# copy; the host reinterprets the fields by fixed offsets. Fields are ordered
# by item size (4-byte first) so every offset stays aligned.

_TORCH_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.int16): torch.int16,
                 np.dtype(np.float32): torch.float32, np.dtype(np.uint8): torch.uint8}


def fetch_layout(bsz: int, k_det: int, k_fuse: int, num_stuff: int,
                 prefix: int):
    """Ordered [(name, shape, dtype)] of the coalesced fetch buffer."""
    return [
        ("offs", (2 * bsz + 1,), np.int32),
        ("order", (bsz, k_fuse), np.int32),
        ("sorted_classes", (bsz, k_fuse), np.int32),
        ("sorted_scores", (bsz, k_fuse), np.float32),
        ("stuff_area", (bsz, num_stuff), np.int32),
        ("det_boxes", (bsz, k_det, 4), np.float32),
        ("det_scores", (bsz, k_det), np.float32),
        ("det_classes", (bsz, k_det), np.int32),
        ("starts", (prefix,), np.int32),
        ("values", (prefix,), np.int16),
        ("takes", (bsz, k_fuse), np.uint8),
        ("stuff_ok", (bsz, num_stuff), np.uint8),
        ("fallback", (bsz,), np.uint8),
        ("det_valid", (bsz, k_det), np.uint8),
    ]


def pack_fetch_buffer(r: PackedRender, det: dict) -> torch.Tensor:
    """Device side: flatten the host-needed fields of one rendered batch
    into a single (N,) uint8 buffer."""
    arrays = {
        "offs": r.offs, "order": r.order,
        "sorted_classes": r.sorted_classes,
        "sorted_scores": r.sorted_scores, "stuff_area": r.stuff_area,
        "det_boxes": det["boxes"], "det_scores": det["scores"],
        "det_classes": det["classes"],
        "starts": r.starts_prefix, "values": r.values_prefix,
        "takes": r.takes, "stuff_ok": r.stuff_ok, "fallback": r.fallback,
        "det_valid": det["valid"],
    }
    bsz, k_fuse = r.takes.shape
    layout = fetch_layout(bsz, det["boxes"].shape[1], k_fuse,
                          r.stuff_ok.shape[1], r.starts_prefix.shape[0])
    parts = []
    for name, _, dt in layout:
        x = arrays[name].to(_TORCH_DTYPES[np.dtype(dt)])
        parts.append(x.contiguous().reshape(-1).view(torch.uint8))
    return torch.cat(parts)


def unpack_fetch_buffer(buf: np.ndarray, layout) -> dict:
    """Host side: reinterpret the fetched uint8 buffer by fixed offsets."""
    buf = np.ascontiguousarray(buf)
    out = {}
    off = 0
    for name, shape, dt in layout:
        count = int(np.prod(shape))
        out[name] = np.frombuffer(
            buf.data, dtype=dt, count=count, offset=off).reshape(shape)
        off += count * np.dtype(dt).itemsize
    assert off == buf.size, (off, buf.size)
    return out


# ---------------------------------------------------------------------------
# Host-side decode
# ---------------------------------------------------------------------------

def rle_decode(starts: np.ndarray, values: np.ndarray, n_runs: int,
               total: int) -> np.ndarray:
    """Inverse of ``rle_encode`` (host, numpy)."""
    n = int(n_runs)
    s = np.asarray(starts[:n], np.int64)
    v = np.asarray(values[:n])
    lengths = np.diff(np.append(s, total))
    return np.repeat(v, lengths)


def decode_rendered_image(
    r: dict,
    canvas: Tuple[int, int],
    orig_hw: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray, List[dict]]:
    """Fetched per-image ``RenderedImage`` fields (numpy dict) ->
    (sem_seg (oh, ow) int32, panoptic (oh, ow) int32, segments_info) with
    the structure of ``panoptic_render.render_panoptic_output``."""
    oh_c, ow_c = canvas
    oh, ow = orig_hw
    total = oh_c * ow_c
    pan = rle_decode(
        r["pan_starts"], r["pan_values"], r["pan_nruns"], total
    ).reshape(oh_c, ow_c)[:oh, :ow].astype(np.int32)
    sem = rle_decode(
        r["sem_starts"], r["sem_values"], r["sem_nruns"], total
    ).reshape(oh_c, ow_c)[:oh, :ow].astype(np.int32)

    segments: List[dict] = []
    takes = np.asarray(r["takes"], bool)
    order = np.asarray(r["order"], np.int64)
    scores = np.asarray(r["sorted_scores"], np.float64)
    classes = np.asarray(r["sorted_classes"], np.int64)
    # detections_to_records filters by valid; a segment's instance_id indexes
    # those filtered arrays (slot -> filtered index = #valid slots before it)
    valid = np.asarray(r["det_valid"], bool)
    filt_idx = np.cumsum(valid) - 1
    cur = 0
    for i in range(len(takes)):
        if not takes[i]:
            continue
        cur += 1
        segments.append({
            "id": cur,
            "isthing": True,
            "score": float(scores[i]),
            "category_id": int(classes[i]),
            "instance_id": int(filt_idx[order[i]]),
        })
    stuff_ok = np.asarray(r["stuff_ok"], bool)
    stuff_area = np.asarray(r["stuff_area"], np.int64)
    for lab in range(1, len(stuff_ok)):
        if not stuff_ok[lab]:
            continue
        cur += 1
        segments.append({
            "id": cur,
            "isthing": False,
            "category_id": int(lab),
            "area": int(stuff_area[lab]),
        })
    return sem, pan, segments
