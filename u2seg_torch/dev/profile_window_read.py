"""Window-read probe (counterpart of ``dev/profile_dma_flat.py``): N windows
of an NHWC bf16 map, each reduced to an ``(8, 128)`` checksum, timed on the
card beside the least time the card could take for them.

    python3 -m u2seg_torch.dev.profile_window_read

``window_sum(..., mode="3d")`` takes window ``(wy, wx, C)`` of the 4-D map
with the x origin aligned down to a multiple of 8; ``mode="flat"`` takes
window ``(wy, wx*C)`` of the ``(B, H, W*C)`` view at element offset ``ox*C``,
no alignment. Element ``e`` of a flattened window goes to slot ``e mod
1024``; G windows make one row of the ``(N/G, 8, 128)`` f32 result, whose last
row is what the JAX probe returns (its grid steps all write one output block).
Origins are clamped into the map.

CPU tensors take the plain version ``window_sum_ref`` (index arithmetic plus
``reshape(-1, 1024).sum``); CUDA tensors launch the kernels of
``csrc/window_probe.cu`` or raise. Launches are counted in
``window_sum.launches``, one per call of a mode. The kernels read each map
byte once: when ``wx*C`` is a multiple of 1024 a window's checksum is its
column-strip sums folded by column, and windows that start on the same row
share their strips (``window_sum_strips_reference`` states that algorithm in
plain PyTorch for the tests). So their time no longer says how fast
overlapping windows can be read one by one: it is the time of one pass over
the map. ``time_shapes`` times the JAX probe's five window shapes and prints
each beside its bound (distinct map bytes read once, output written once,
over the card's memory rate) and the share of the bound it reaches; its GB/s
column is the window bytes over the time, an effective rate. ``main()``
needs a GPU.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from u2seg_torch import _cuda

SLOTS = 1024        # the (8, 128) checksum
GROUP = 8           # windows per output row
# (name, mode, wy, wx) as the JAX probe lists them
SHAPES = (
    ("3d  40x32 (current)", "3d", 32, 40),
    ("flat 40x32", "flat", 32, 40),
    ("flat 32x32", "flat", 32, 32),
    ("flat 16x16", "flat", 16, 16),
    ("3d  24x16 (small tier)", "3d", 16, 24),
)
MAP_SHAPE = (8, 200, 336, 256)      # B, H, W, C
NUM_WINDOWS = 8000
# The kernels' shared-memory plan (csrc/window_probe.cu::make_plan): 32
# bytes of barriers, a ring of wy + AHEAD + 1 map rows of 16 bytes a column, two strip buffers of 32
# bytes a column, at least MIN_RECORDS window records of 8 bytes, the image's
# H + 1 row starts; at most SMEM_BYTES and MAX_COLUMNS columns a block. The
# routing keeps a count per (row, warp) in shared memory: H <= MAX_ROWS.
AHEAD, MIN_RECORDS, SMEM_BYTES, MAX_COLUMNS, MAX_ROWS = 4, 64, 232448, 896, 1536
# NVIDIA's data sheet for the H100 SXM: HBM rate, f32 rate outside the tensor cores
PEAK_BYTES_PER_S, PEAK_F32_FLOPS = 3.35e12, 67e12


def _clamped_origins(feat, oy, ox, b, wy: int, wx: int, mode: str):
    bsz, h, w, _ = feat.shape
    b = torch.clamp(b.long(), 0, bsz - 1)
    oy = torch.clamp(oy.long(), 0, h - wy)
    ox = torch.clamp(ox.long(), 0, w - wx)
    if mode == "3d":
        ox = ox // 8 * 8
    return oy, ox, b


def window_sum_ref(feat: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                   b: torch.Tensor, wy: int, wx: int, mode: str,
                   g: int = GROUP, chunk_groups: int = 64) -> torch.Tensor:
    """Plain version of both kernels -> (N/g, 8, 128) f32. Works through
    ``chunk_groups`` groups at a time to bound the gathered windows."""
    _check_shapes(feat, oy, wy, wx, mode, g)
    c = feat.shape[-1]
    oy, ox, b = _clamped_origins(feat, oy, ox, b, wy, wx, mode)
    rows = oy[:, None] + torch.arange(wy, device=feat.device)
    cols = ox[:, None] + torch.arange(wx, device=feat.device)
    out = []
    step = chunk_groups * g
    for i in range(0, oy.shape[0], step):
        win = feat[b[i:i + step, None, None], rows[i:i + step, :, None],
                   cols[i:i + step, None, :]]             # (n, wy, wx, C)
        n = win.shape[0]
        out.append(win.to(torch.float32).reshape(
            n // g, g * wy * wx * c // SLOTS, SLOTS).sum(dim=1))
    if not out:
        return torch.zeros((0, 8, 128), dtype=torch.float32, device=feat.device)
    return torch.cat(out).reshape(-1, 8, 128)


def window_routing(oy: torch.Tensor, b: torch.Tensor, batch: int, height: int,
                   wy: int):
    """Plain version of the routing kernel, torch ops: ``row_start`` (batch * height + 1,) and ``order`` (N,) int32, where the
    windows of image ``b`` whose clamped origin row is ``oy`` are
    ``order[row_start[b * height + oy]:row_start[b * height + oy + 1]]`` in
    ascending index. The keys (list, index) are unique, so the sort has one
    answer."""
    n = oy.shape[0]
    dev = oy.device
    lists = (torch.clamp(b.long(), 0, batch - 1) * height
             + torch.clamp(oy.long(), 0, height - wy))
    keys = torch.sort(lists * n + torch.arange(n, device=dev)).values
    row_start = torch.searchsorted(
        keys, torch.arange(batch * height + 1, device=dev) * n)
    return row_start.to(torch.int32), (keys % n).to(torch.int32)


def slot_period(c: int) -> int:
    """D: columns x and x + D of a window land on the same slots."""
    return SLOTS // math.gcd(c, SLOTS)


def window_sum_strips_reference(feat: torch.Tensor, oy: torch.Tensor,
                                ox: torch.Tensor, b: torch.Tensor, wy: int,
                                wx: int, mode: str, g: int = GROUP) -> torch.Tensor:
    """The kernels' algorithm in plain PyTorch, for the tests -> (N/g, 8, 128)
    f32. The routing lists of ``window_routing``; per image, the column-strip
    sums of the last wy rows kept running down the map (add the row that
    enters, then subtract the row that leaves); when origin row oy is
    complete, every window of its list folds its columns: residue r of the
    column index mod D (``slot_period``) sums its columns in ascending x into
    P[n, r*C:(r+1)*C]; then row g of the result sums P[n, k*1024:(k+1)*1024]
    over the group's windows in ascending index, k ascending inside. The
    same operations in the same order as the kernels, one element at a
    time."""
    _check_shapes(feat, oy, wy, wx, mode, g)
    check_kernel_shapes(feat.shape, wy, wx)
    bsz, h, w, c = feat.shape
    n = oy.shape[0]
    d = slot_period(c)
    row_start, order = window_routing(oy, b, bsz, h, wy)
    _, x0, _ = _clamped_origins(feat, oy, ox, b, wy, wx, mode)
    row_start, order, x0 = row_start.tolist(), order.tolist(), x0.tolist()
    f = feat.to(torch.float32)
    part = torch.zeros((n, d * c), dtype=torch.float32, device=feat.device)
    for img in range(bsz):
        strip = torch.zeros((w, c), dtype=torch.float32, device=feat.device)
        for y in range(h):
            strip = strip + f[img, y]
            if y >= wy:
                strip = strip - f[img, y - wy]
            if y < wy - 1:
                continue
            first = img * h + y - wy + 1
            for k in order[row_start[first]:row_start[first + 1]]:
                for r in range(d):
                    cols = strip[x0[k] + r:x0[k] + wx:d]
                    acc = cols[0]
                    for col in cols[1:]:
                        acc = acc + col
                    part[k, r * c:(r + 1) * c] = acc
    out = torch.zeros((n // g, SLOTS), dtype=torch.float32, device=feat.device)
    for j in range(g):
        for k in range(0, d * c, SLOTS):
            out = out + part[j::g, k:k + SLOTS]
    return out.reshape(-1, 8, 128)


def _check_shapes(feat, oy, wy, wx, mode, g):
    if mode not in ("3d", "flat"):
        raise ValueError(f"unknown mode {mode!r}")
    if feat.dim() != 4:
        raise ValueError("the map must be (B, H, W, C)")
    _, h, w, c = feat.shape
    if (oy.shape[0] % g or wy > h or wx > w or c % 8
            or (wy * wx * c) % SLOTS):
        raise ValueError("needs N % g == 0, a window inside the map, C % 8 "
                         "== 0 and wy*wx*C % 1024 == 0")


def check_kernel_shapes(shape, wy: int, wx: int) -> None:
    """What the kernels take beyond the plain version: ``wx*C`` a multiple of
    1024 (a window's slots then do not depend on its row), a ring of wy +
    AHEAD + 1 rows that fits in shared memory for one owned column, and at
    most MAX_ROWS rows."""
    _, h, _, c = shape
    if (wx * c) % SLOTS:
        raise ValueError(f"the kernels need wx*C % 1024 == 0 (wx={wx}, C={c})")
    if h > MAX_ROWS:
        raise ValueError(f"the routing takes at most {MAX_ROWS} rows")
    fixed = (h + 1) * 4 + MIN_RECORDS * 8 + 32
    per_column = (wy + AHEAD + 1) * 16 + 2 * 32
    if wx > MAX_COLUMNS or fixed + wx * per_column > SMEM_BYTES:
        raise ValueError(f"a {wy} x {wx} window's ring does not fit in shared memory")


@functools.lru_cache(maxsize=None)
def _c_fn(mode: str):
    lib = _cuda.load("window_probe")
    fn = getattr(lib, f"u2seg_window_sum_{mode}")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6)
    return lib, fn


def window_sum(feat: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
               b: torch.Tensor, wy: int, wx: int, mode: str,
               g: int = GROUP) -> torch.Tensor:
    """Checksums of N windows of ``feat`` (B, H, W, C) bf16 at origins
    ``(oy, ox)`` of images ``b`` (each (N,) int32), ``g`` windows per row of
    the (N/g, 8, 128) f32 result.

    CPU tensors take the plain version. CUDA tensors launch the kernels of
    ``mode`` (routing, strips, groups); any input they do not take raises."""
    if feat.device.type == "cpu":
        return window_sum_ref(feat, oy, ox, b, wy, wx, mode, g)
    return launch(feat, oy, ox, b, wy, wx, mode, g)[0]


def launch(feat, oy, ox, b, wy: int, wx: int, mode: str, g: int = GROUP):
    """``window_sum`` on CUDA tensors -> (out, row_start, order): the result
    and the routing kernel's lists, which ``window_routing`` states."""
    _check_shapes(feat, oy, wy, wx, mode, g)
    check_kernel_shapes(feat.shape, wy, wx)
    dev = feat.device
    if (dev.type != "cuda" or feat.dtype != torch.bfloat16 or not feat.is_contiguous()
            or feat.data_ptr() % 16):
        raise ValueError("the map must be contiguous CUDA bf16, 16-byte aligned")
    for t in (oy, ox, b):
        if (t.dtype != torch.int32 or t.device != dev or t.shape != oy.shape
                or t.dim() != 1 or not t.is_contiguous()):
            raise ValueError("origins must be contiguous (N,) int32 tensors "
                             "on the map's device")
    n = oy.shape[0]
    bsz, h, w, c = feat.shape
    out = torch.empty((n // g, 8, 128), dtype=torch.float32, device=dev)
    row_start = torch.empty(bsz * h + 1, dtype=torch.int32, device=dev)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:              # nothing to launch, nothing to count
        return out, row_start.zero_(), order
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    partial = torch.empty((n, slot_period(c) * c), dtype=torch.float32, device=dev)
    lib, fn = _c_fn(mode)
    code = fn(feat.data_ptr(), bsz, h, w, c, oy.data_ptr(), ox.data_ptr(), b.data_ptr(),
              n, g, wy, wx, row_start.data_ptr(), order.data_ptr(), rank.data_ptr(),
              partial.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, code, f"window_sum_{mode} launch")
    window_sum.launches[mode] += 1
    return out, row_start, order


window_sum.launches = {"3d": 0, "flat": 0}


def make_map(seed: int, device, shape=MAP_SHAPE) -> torch.Tensor:
    """The probe's map: seeded normal values in bf16."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)


def make_origins(rng: np.random.RandomState, n: int, shape, wy: int, wx: int,
                 mode: str, device):
    """Origins as the JAX probe draws them (x aligned to 8 for "3d")."""
    bsz, h, w, _ = shape
    oy = rng.randint(0, h - wy, n).astype(np.int32)
    ox = rng.randint(0, w - wx - 8, n).astype(np.int32)
    if mode == "3d":
        ox = (ox // 8) * 8
    b = rng.randint(0, bsz, n).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (oy, ox, b))


def check_cases(rng: np.random.RandomState, shape, wy: int, wx: int, mode: str,
                device, shared: int = 4096):
    """Origin sets that the kernels are checked on, name -> (oy, ox, b):
    ``random`` (N=512 as ``make_origins`` draws them; 3d origins moved off
    the 8-grid), ``edge`` (N=64: windows on the last row and column,
    unaligned 3d origins, origins and images past the map that the clamp
    brings back, the rest random) and ``shared`` (N=``shared``, every window
    on one (image, origin row); at 4096 the list is longer than the records
    a block stages at once)."""
    bsz, h, w, _ = shape
    oy, ox, b = make_origins(rng, 512, shape, wy, wx, mode, "cpu")
    cases = {"random": (oy, ox + 5 if mode == "3d" else ox, b)}
    picks = [(h - wy, w - wx, 0), (h - wy, w - wx, bsz - 1), (h - wy, w - wx - 3, 1),
             (0, w - wx - 5, bsz - 1), (h - wy - 1, 3, 0), (h + 7, w + 50, 1),
             (-5, -13, bsz - 1), (h * 3, 2 * w, bsz + 2), (4, w - wx + 9, -1),
             (h - wy + 1, 11, bsz)]
    oy, ox, b = make_origins(rng, 64, shape, wy, wx, mode, "cpu")
    for i, pick in enumerate(picks):
        oy[i], ox[i], b[i] = pick
    cases["edge"] = (oy, ox, b)
    cases["shared"] = (torch.full((shared,), min(17, h - wy), dtype=torch.int32),
                       torch.from_numpy(rng.randint(-4, w - wx + 4, shared).astype(np.int32)),
                       torch.full((shared,), bsz // 2, dtype=torch.int32))
    return {k: tuple(t.to(device) for t in v) for k, v in cases.items()}


def work_of(feat, oy, ox, b, wy: int, wx: int, mode: str, g: int = GROUP):
    """(bytes, flops) the checksums need at least: every distinct map cell
    the windows touch read once, the output written once, the origins read
    once; one add per window element."""
    bsz, h, w, c = feat.shape
    oy, ox, b = _clamped_origins(feat, oy, ox, b, wy, wx, mode)
    dev = feat.device
    cells = ((b[:, None, None] * h + oy[:, None, None]
              + torch.arange(wy, device=dev)[None, :, None]) * w
             + ox[:, None, None] + torch.arange(wx, device=dev)[None, None, :])
    seen = torch.zeros(bsz * h * w, dtype=torch.bool, device=dev)
    seen[cells.reshape(-1)] = True
    n = oy.shape[0]
    nbytes = int(seen.sum()) * c * feat.element_size() + n // g * SLOTS * 4 + n * 12
    return nbytes, n * wy * wx * c


def time_shapes(feat: torch.Tensor, n: int = NUM_WINDOWS, iters: int = 20):
    """Time every shape of ``SHAPES`` on the card -> list of dicts: name,
    mode, wy, wx, window bytes, ``ms`` (device time of a whole call: its
    three launches, ``iters`` calls captured into one CUDA graph and
    replayed), ``call_ms`` (CUDA events
    around ``iters`` calls launched one by one: the host's enqueue included),
    ``bound_ms`` / ``bound_by`` (``work_of`` over the card's peak rates),
    ``share`` (bound / ms) and ``gb_per_s`` (window bytes / ms, effective)."""
    from u2seg_torch.dev.sweep_forward_plan import graph_ms

    rng = np.random.RandomState(0)
    rows = []
    for name, mode, wy, wx in SHAPES:
        oy, ox, b = make_origins(rng, n, feat.shape, wy, wx, mode, feat.device)
        run = lambda: window_sum(feat, oy, ox, b, wy, wx, mode)
        ms = graph_ms([run], iters=iters)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            run()
        t1.record()
        torch.cuda.synchronize()
        call_ms = t0.elapsed_time(t1) / iters
        nbytes, flops = work_of(feat, oy, ox, b, wy, wx, mode)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
        window_bytes = n * wy * wx * feat.shape[-1] * feat.element_size()
        bound = max(t_bytes, t_ops)
        rows.append(dict(name=name, mode=mode, wy=wy, wx=wx, bytes=window_bytes,
                         ms=ms, call_ms=call_ms,
                         distinct_bytes=nbytes, bound_ms=bound,
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         share=bound / ms, gb_per_s=window_bytes / ms / 1e6))
    return rows


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probe times kernels on the card")
    from u2seg_torch.dev.sweep_forward_plan import smi_line

    dev = torch.device("cuda", 0)
    print(f"device: {smi_line()}", flush=True)
    feat = make_map(0, dev)
    for row in time_shapes(feat):
        print(f"{row['name']:24s} {row['ms']:.4f} ms (launched call by call "
              f"{row['call_ms']:.4f}), bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
              f"({row['distinct_bytes'] / 1e6:.1f} MB), {row['share']:.2f} of the "
              f"bound; {row['bytes'] / 1e9:.2f} GB of window bytes -> "
              f"{row['gb_per_s']:.1f} GB/s effective", flush=True)


if __name__ == "__main__":
    main()
