"""Window-read probe: what per-ROI window reads out of an NHWC pyramid reach
on the card, in GB/s (counterpart of ``dev/profile_dma_flat.py``).

    python3 -m u2seg_torch.dev.profile_window_read

Two hand-written CUDA kernels (``csrc/window_probe.cu``) read N windows of a
``(B, H, W, C)`` bf16 map, G windows per block, and reduce each group to an
``(8, 128)`` f32 checksum (element ``e`` of the flattened window goes to slot
``e mod 1024``):

- ``window_sum(..., mode="3d")``: window ``(wy, wx, C)`` of the 4-D map with
  the x origin aligned down to a multiple of 8;
- ``window_sum(..., mode="flat")``: window ``(wy, wx*C)`` of the ``(B, H,
  W*C)`` view at element offset ``ox*C``, no alignment.

Both return ``(N/G, 8, 128)``; the last row is what the JAX probe returns
(its grid steps all write one output block). ``window_sum_ref`` is the plain
version: index arithmetic plus ``reshape(-1, 1024).sum``. CPU tensors take
it; CUDA tensors launch the kernel or raise. Launches are counted in
``window_sum.launches`` per mode.

The timings say how fast the redesigned ROIAlign kernels can hope to read
their windows: a practical bound beside the data sheet's memory rate.
``main()`` times the JAX probe's five window shapes and needs a GPU.
"""
from __future__ import annotations

import ctypes
import functools
import subprocess

import numpy as np
import torch

from u2seg_torch import _cuda

SLOTS = 1024        # the (8, 128) checksum
GROUP = 8           # windows per block
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


@functools.lru_cache(maxsize=None)
def _c_fn(mode: str):
    lib = _cuda.load("window_probe")
    fn = getattr(lib, f"u2seg_window_sum_{mode}")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 2)
    return lib, fn


def window_sum(feat: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
               b: torch.Tensor, wy: int, wx: int, mode: str,
               g: int = GROUP) -> torch.Tensor:
    """Checksums of N windows of ``feat`` (B, H, W, C) bf16 at origins
    ``(oy, ox)`` of images ``b`` (each (N,) int32), ``g`` windows per row of
    the (N/g, 8, 128) f32 result.

    CPU tensors take the plain version. CUDA tensors launch the kernel of
    ``mode``; any input the kernel does not take raises."""
    if feat.device.type == "cpu":
        return window_sum_ref(feat, oy, ox, b, wy, wx, mode, g)
    _check_shapes(feat, oy, wy, wx, mode, g)
    dev = feat.device
    if (feat.dtype != torch.bfloat16 or not feat.is_contiguous()
            or feat.data_ptr() % 16):
        raise ValueError("the map must be contiguous bf16, 16-byte aligned")
    for t in (oy, ox, b):
        if (t.dtype != torch.int32 or t.device != dev or t.shape != oy.shape
                or t.dim() != 1 or not t.is_contiguous()):
            raise ValueError("origins must be contiguous (N,) int32 tensors "
                             "on the map's device")
    n = oy.shape[0]
    out = torch.empty((n // g, 8, 128), dtype=torch.float32, device=dev)
    if n == 0:              # nothing to launch, nothing to count
        return out
    lib, fn = _c_fn(mode)
    bsz, h, w, c = feat.shape
    code = fn(feat.data_ptr(), bsz, h, w, c, oy.data_ptr(), ox.data_ptr(),
              b.data_ptr(), n, g, wy, wx, out.data_ptr(),
              torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, code, f"window_sum_{mode} launch")
    window_sum.launches[mode] += 1
    return out


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


def time_shapes(feat: torch.Tensor, n: int = NUM_WINDOWS, iters: int = 30):
    """Time every shape of ``SHAPES`` on the card -> list of dicts (name,
    mode, wy, wx, window bytes, ms, GB/s)."""
    rng = np.random.RandomState(0)
    rows = []
    for name, mode, wy, wx in SHAPES:
        oy, ox, b = make_origins(rng, n, feat.shape, wy, wx, mode, feat.device)
        run = lambda: window_sum(feat, oy, ox, b, wy, wx, mode)
        run()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            run()
        t1.record()
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1) / iters
        nbytes = n * wy * wx * feat.shape[-1] * 2
        rows.append(dict(name=name, mode=mode, wy=wy, wx=wx, bytes=nbytes,
                         ms=ms, gb_per_s=nbytes / ms / 1e6))
    return rows


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probe times kernels on the card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    feat = make_map(0, dev)
    for row in time_shapes(feat):
        print(f"{row['name']:24s} [{row['bytes'] / 1e9:.2f} GB] "
              f"{row['ms']:7.3f} ms  {row['gb_per_s']:7.1f} GB/s", flush=True)


if __name__ == "__main__":
    main()
