"""Throughput of the train step, the inference forward and the train loader
(counterpart of ``tools/benchmark.py``).

    python -m u2seg_torch.tools.benchmark --task {train,eval,data} [--config-file FILE] [--iters N] [--device cpu] [key.path=value ...]

``train`` and ``eval`` time numpy-drawn batches at the training bucket
(800x1344) on ``--device`` and synchronise before reading the clock; ``data``
times ``train_net.build_train_loader`` on the files of
``cfg.datasets.train`` (host only). Each prints one line of the task's
numbers.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_train(cfg, device="cuda", iters: int = 10, batch: Optional[int] = None,
                    h: int = 800, w: int = 1344) -> dict:
    """Steps of ``make_train_step`` on one drawn batch (20 boxes, 64x64 mask
    patches); the first step is reported apart."""
    from u2seg_torch.engine.trainer import Batch, create_train_state, make_train_step
    from u2seg_torch.structures.instances import GtInstances

    b = batch or 2
    rng = np.random.RandomState(0)
    g = 20
    xy = rng.rand(b, g, 2) * (h / 2)
    wh = rng.rand(b, g, 2) * (h / 3) + 8
    state = create_train_state(cfg, device=device, seed=0)
    dev = next(state.model.parameters()).device
    bt = Batch(
        images=torch.from_numpy(rng.rand(b, h, w, 3).astype(np.float32) * 255),
        image_sizes=torch.tensor([[h, w]] * b, dtype=torch.int32),
        gt=GtInstances(
            boxes=torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32)),
            classes=torch.from_numpy(rng.randint(
                0, cfg.model.roi_heads.num_classes, (b, g)).astype(np.int32)),
            valid=torch.ones((b, g), dtype=torch.bool),
            masks=torch.from_numpy((rng.rand(b, g, 64, 64) > 0.4).astype(np.float32))),
        sem_seg=torch.from_numpy(rng.randint(
            0, cfg.model.sem_seg_head.num_classes, (b, h, w)).astype(np.int32))).to(dev)
    step = make_train_step(state.model, state.optimizer)
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    step(bt, gen)
    _sync(dev)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        m = step(bt, gen)
    float(m["total_loss"])
    dt = time.perf_counter() - t0
    return {"imgs_per_sec": b * iters / dt, "sec_per_iter": dt / iters, "first_sec": first}


def benchmark_eval(cfg, device="cuda", iters: int = 20, batch: int = 4,
                   h: int = 800, w: int = 1344) -> dict:
    """Inference forwards (fusion included) of one drawn batch."""
    from u2seg_torch.models.build import build_model

    model = build_model(cfg, device=device)
    dev = next(model.parameters()).device
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(batch, h, w, 3).astype(np.float32) * 255).to(dev)
    sizes = torch.tensor([[h, w]] * batch, dtype=torch.int32, device=dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        model(images, sizes, combine=True)
        _sync(dev)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(iters):
            model(images, sizes, combine=True)
        _sync(dev)
    dt = time.perf_counter() - t0
    return {"imgs_per_sec": batch * iters / dt, "sec_per_batch": dt / iters,
            "first_sec": first}


def benchmark_data(cfg, iters: int = 50) -> dict:
    """Batches of the train loader after one warm-up batch."""
    from u2seg_torch.tools.train_net import build_train_loader

    loader = build_train_loader(cfg)
    it = iter(loader)
    b = len(next(it)["image"])
    t0 = time.perf_counter()
    for _ in range(iters):
        next(it)
    dt = time.perf_counter() - t0
    if hasattr(loader, "close"):
        loader.close()
    return {"batches_per_sec": iters / dt, "images_per_sec": b * iters / dt,
            "num_workers": cfg.dataloader.num_workers}


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config-file", default="")
    parser.add_argument("--task", default="eval", choices=["train", "eval", "data"])
    parser.add_argument("--iters", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)

    from u2seg_torch.config import load_config

    cfg = load_config(args.config_file or None, args.opts)
    kwargs = {"iters": args.iters} if args.iters else {}
    if args.task != "data":
        kwargs["device"] = args.device
    fn = {"train": benchmark_train, "eval": benchmark_eval, "data": benchmark_data}[args.task]
    res = fn(cfg, **kwargs)
    print(args.task, res, flush=True)
    return res


if __name__ == "__main__":
    main()
