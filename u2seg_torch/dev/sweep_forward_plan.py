"""Times the forward pooler kernel under alternative launch plans on the card.

    python3 -m u2seg_torch.dev.sweep_forward_plan [--report PATH]

``ops/roi_align_ml.forward_plan(s)`` fixes the block size and the stage buffer
of the span forward kernel by output size; nothing else sets them. This
script is where that choice is measured: at the serving path's shapes (p2-p5
of an 800x1216 image, C=256, bf16; R=1000 at s=7, R=100 at s=14, and R=256 at
s=14, the mask branch's count in a train step) it replaces
``forward_plan`` by each candidate in turn and reads the device time of 48
launches captured into one CUDA graph (no host code between them), with L2
warm (one launch repeated) and with L2 exceeded (rotating over 4 copies of
levels and output). The whole sweep runs twice, the second time in reverse
order, and both readings are printed, so that a difference smaller than the
spread between the passes is seen as such. The shipped plan is marked.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch

from u2seg_torch.ops import roi_align_ml as rap

STRIDES = (4, 8, 16, 32)
CANDIDATES = [(threads, kb << 10) for threads in (64, 128, 256)
              for kb in (16, 24, 32, 48, 64)]
ROTATION = 4


def graph_ms(fns, iters: int = 48, replays: int = 5) -> float:
    """Device ms per call: ``iters`` calls, taking ``fns`` in rotation, are
    captured into one CUDA graph and the graph is replayed ``replays`` times
    between two events; the median replay over ``iters``. No host code runs
    between the launches of a replay, so a kernel of a few tens of
    microseconds is not timed at the rate the host can enqueue it. Each
    function must launch on the current stream and allocate nothing."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    readings = []
    for _ in range(replays):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        readings.append(t0.elapsed_time(t1) / iters)
    return float(np.median(readings))


def proposals(rng, n: int, h: int, w: int) -> torch.Tensor:
    """Log-uniform box sizes (8-800 px), aspect within e^1.2, clipped."""
    cx, cy = rng.rand(n) * w, rng.rand(n) * h
    bw = np.exp(rng.uniform(np.log(8), np.log(800), n))
    bh = bw * np.exp(rng.uniform(-1.2, 1.2, n))
    b = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)
    b[:, 0::2] = b[:, 0::2].clip(0, w)
    b[:, 1::2] = b[:, 1::2].clip(0, h)
    return torch.from_numpy(b.astype(np.float32))


def time_plans(module, name: str, fns, s: int, candidates=CANDIDATES):
    """``module.<name>`` (a function of s giving threads and stage bytes)
    replaced by each candidate in turn, twice, the second pass in reverse
    order: {"threads/stage": [warm pass 1, pass 2, cold pass 1, pass 2]},
    warm from ``fns[:1]``, cold from all of ``fns``."""
    shipped = getattr(module, name)
    rows = {f"{t}/{b >> 10}K": [] for t, b in candidates}
    try:
        for order in (candidates, candidates[::-1]):
            for threads, stage in order:
                if threads < 2 * s:       # the sources need a thread per (axis, bin)
                    continue
                setattr(module, name, lambda _s, plan=(threads, stage): plan)
                rows[f"{threads}/{stage >> 10}K"] += [graph_ms(fns[:1]), graph_ms(fns)]
    finally:
        setattr(module, name, shipped)
    return {k: [v[0], v[2], v[1], v[3]] for k, v in rows.items() if v}


def print_plans(title: str, rows, shipped: str, mark: str) -> None:
    print(f"[sweep] {title}, device ms per launch (graph of 48): threads/stage "
          f"buffer: L2 warm pass 1, pass 2 | L2 exceeded pass 1, pass 2", flush=True)
    for key, v in rows.items():
        tag = f"  <- {mark}" if key == shipped else ""
        print(f"[sweep]   {key:>8}: {v[0]:.4f} {v[1]:.4f} | {v[2]:.4f} {v[3]:.4f}{tag}",
              flush=True)


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sweep(dev, s: int, n: int):
    """The forward kernel's plans at output size s over R=n proposals."""
    h, w, c = 800, 1216, 256
    gen = torch.Generator(device=dev).manual_seed(0)
    sets = [[torch.randn(1, h // st, w // st, c, generator=gen, device=dev)
             .to(torch.bfloat16) for st in STRIDES] for _ in range(ROTATION)]
    boxes = proposals(np.random.RandomState(0), n, h, w).to(dev)
    bidx = torch.zeros(n, dtype=torch.int32, device=dev)
    args = [rap.prepare_launch(fs, boxes, bidx, s, 2, STRIDES, 224.0, 4,
                               torch.bfloat16) for fs in sets]
    return time_plans(rap, "forward_plan", [lambda a=a: rap.launch(a) for a in args], s)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", help="also write the readings as JSON here")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_forward_plan: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = smi_line()
    print(f"[device] {smi}", flush=True)
    report = {"smi": smi}
    for s, n in ((7, 1000), (14, 100), (14, 256)):
        rows = sweep(dev, s, n)
        threads, stage = rap.forward_plan(s)
        report[f"s{s}_R{n}"] = rows
        print_plans(f"s={s} R={n} bf16", rows, f"{threads}/{stage >> 10}K", "forward_plan")
    if a.report:
        os.makedirs(os.path.dirname(os.path.abspath(a.report)), exist_ok=True)
        with open(a.report, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
