"""Times the single-level window ROIAlign kernel (K4) on the card.

    python3 -m u2seg_torch.dev.time_roi_align_single [--against PATH]... [--against-first PATH] [--report PATH]

At the shapes of ``chip_smoke.py`` phase ``k4`` (p3 of an 800x1216 image:
100x152, C=256, bf16 map, f32 out; R=1000 at s=7 and s=14) it reads device
times with ``graph_ms`` (48 launches captured into one CUDA graph, no host
code between them), with L2 warm (one launch repeated) and with L2 exceeded
(rotating over 4 copies of map and output):

- under each candidate launch plan (block size / stage buffer) in place of
  ``ops/roi_align_single.launch_plan``, twice, the second pass in reverse
  order, so that a difference below the spread between passes shows as such;
  the shipped plan is marked;
- in turns (other, shipped, shipped, other) against other builds of the
  kernel: ``--against PATH`` is a ``.cu`` file with the shipped source's C
  interface (a variant of it); ``--against-first PATH`` one with the first
  kernel's interface, which takes no launch plan (export that source from
  version control; the repository keeps no copy). Each is held to the
  shipped kernel's result first. Sources build like the shipped one
  (``_cuda.build``), into ``build/u2seg_torch_kernels/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os

import numpy as np
import torch

from u2seg_torch import _cuda
from u2seg_torch.dev.sweep_forward_plan import graph_ms, print_plans, smi_line, time_plans
from u2seg_torch.ops import roi_align_single as ras

K4_HW, K4_STRIDE = (100, 152), 8        # p3 of an 800x1216 image
CHANNELS = 256
ROTATION = 4


def k4_boxes(rng, n: int):
    """Boxes for the 40 x 40 window at stride 8: an x span <= 29 cells (232
    px) and a y span <= 36 cells always fit; the first ``n_edge`` sit on and
    around those budgets. Returns (boxes (n, 4) f32, n_edge)."""
    h, w = K4_HW[0] * K4_STRIDE, K4_HW[1] * K4_STRIDE
    edge = np.array([
        [63.0, 40.0, 63.0 + 232.0, 200.0],     # x span exactly 29 cells, origin 7 off alignment
        [16.0, 8.0, 120.0, 8.0 + 288.0],       # y span exactly 36 cells
        [63.0, 40.0, 63.0 + 248.0, 200.0],     # x span 31 cells: one past the budget
        [100.0, 100.0, 500.0, 420.0],          # over-long: 50 x 40 cells
        [0.0, 0.0, 0.0, 0.0],                  # zero box
        [300.0, 300.0, 300.0, 300.0],          # zero size
        [w - 100.0, h - 90.0, w + 60.0, h + 40.0],   # past the map's corner
        [w - 200.0, h - 200.0, w - 8.0, h - 8.0],    # origin clipped at the far corner
        [12.5, 7.25, 44.75, 39.5],             # small, fractional
    ], np.float32)
    m = n - len(edge)
    bw = np.exp(rng.uniform(np.log(8), np.log(230), m))
    bh = np.exp(rng.uniform(np.log(8), np.log(230), m))
    x0, y0 = rng.rand(m) * (w - bw), rng.rand(m) * (h - bh)
    rand = np.stack([x0, y0, x0 + bw, y0 + bh], 1).astype(np.float32)
    return torch.from_numpy(np.concatenate([edge, rand])), len(edge)


def timing_args(dev, s: int, copies: int = ROTATION, seed: int = 5):
    """``copies`` launch arguments over copies of one bf16 map (and outputs of
    their own), R=1000 boxes from ``k4_boxes``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    base = torch.randn(1, *K4_HW, CHANNELS, generator=gen, device=dev)
    boxes = k4_boxes(np.random.RandomState(seed), 1000)[0].to(dev)
    bidx = torch.zeros(len(boxes), dtype=torch.int32, device=dev)
    return [ras.prepare_launch(base.to(torch.bfloat16), boxes, bidx, s, 2,
                               1.0 / K4_STRIDE) for _ in range(copies)]


def other_kernel(path: str, first: bool):
    """A launcher of another build of the kernel: a function of LaunchArgs
    that writes into a copy of their output and returns it."""
    lib = ctypes.CDLL(_cuda.build([path])[path])
    fn = lib.u2seg_roi_align_single_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * (5 if first else 7) + [ctypes.c_void_p])
    outs = {}

    def run(a: ras.LaunchArgs) -> torch.Tensor:
        hit = outs.get(id(a))
        if hit is None or hit[0] is not a:     # allocated before graph_ms captures;
            hit = outs[id(a)] = (a, torch.empty_like(a.out))   # a stays alive: no id reuse
        out = hit[1]
        b, h, w, c = a.features.shape
        plan = () if first else ras.launch_plan(a.s)
        code = fn(a.features.data_ptr(), b, h, w, c, a.origin.data_ptr(),
                  a.batch.data_ptr(), a.meta.data_ptr(), out.data_ptr(),
                  a.origin.shape[0], a.s, a.r, ras.WIN,
                  ras._DTYPE_CODES[a.features.dtype], *plan,
                  torch.cuda.current_stream(out.device).cuda_stream)
        _cuda.check(lib, code, f"{os.path.basename(path)} launch")
        return out
    return run


def in_turns(dev, s: int, run_other, iters: int = 48):
    """(other, shipped, shipped, other) with L2 warm and with L2 exceeded:
    {"warm": [4 ms], "cold": [4 ms], "max_abs_diff": x}."""
    args = timing_args(dev, s)
    diff = float((run_other(args[0]) - ras.launch(args[0])).abs().max())
    rec = {"max_abs_diff": diff}
    for name, group in (("warm", args[:1]), ("cold", args)):
        other = [lambda a=a: run_other(a) for a in group]
        new = [lambda a=a: ras.launch(a) for a in group]
        rec[name] = [graph_ms(fns, iters) for fns in (other, new, new, other)]
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="a .cu variant with the shipped C interface")
    ap.add_argument("--against-first", help="a .cu file with the first kernel's C interface")
    ap.add_argument("--report", help="also write the readings as JSON here")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_roi_align_single: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = smi_line()
    print(f"[device] {smi}", flush=True)
    report = {"smi": smi}
    others = [(p, False) for p in a.against]
    if a.against_first:
        others.append((a.against_first, True))
    for path, first in others:
        for s in (7, 14):
            rec = in_turns(dev, s, other_kernel(path, first))
            report[f"{os.path.basename(path)}_s{s}"] = rec
            w, c = rec["warm"], rec["cold"]
            print(f"[turns] {os.path.basename(path)} against the shipped kernel, s={s} "
                  f"R=1000 bf16, device ms (other, shipped, shipped, other): L2 warm "
                  f"{', '.join(f'{t:.4f}' for t in w)} -> {(w[0] + w[3]) / 2:.4f} vs "
                  f"{(w[1] + w[2]) / 2:.4f}; L2 exceeded {', '.join(f'{t:.4f}' for t in c)} "
                  f"-> {(c[0] + c[3]) / 2:.4f} vs {(c[1] + c[2]) / 2:.4f}; max|other-shipped| "
                  f"{rec['max_abs_diff']:.2e}", flush=True)
    for s in (7, 14):
        fns = [lambda x=x: ras.launch(x) for x in timing_args(dev, s)]
        rows = time_plans(ras, "launch_plan", fns, s)
        threads, stage = ras.launch_plan(s)
        report[f"plans_s{s}"] = rows
        print_plans(f"s={s} R=1000 bf16", rows, f"{threads}/{stage >> 10}K", "launch_plan")
    if a.report:
        os.makedirs(os.path.dirname(os.path.abspath(a.report)), exist_ok=True)
        with open(a.report, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
