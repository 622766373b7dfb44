"""Loader-contention probe: how fast the train loader maps, and how much it
slows a thread that dispatches small torch ops while it streams.

    python3 -m u2seg_torch.dev.loader_contention --config-file CFG \\
        --root DATASETS [--batch-rate 4] [--seconds 10] [--device cpu] \\
        [--out probe.jsonl] [key.path=value ...]

``CFG`` is a YAML file for ``config.load_config``, or a flattened one whose
keys are dotted paths (read as ``key=value`` overrides; its ``source``,
``reduced`` and ``assumed`` are skipped). ``DATASETS`` holds the training
set where ``register_all_coco`` looks. The loaders come from
``train_net.build_train_loader``, as the trainer's does. It prints:

- ``map_ms_per_image``: the mapper on this thread (``dataloader.num_workers
  = 0``), wall and process CPU ms per image, over ``--images`` images, on
  torch's own number of threads and (``map_ms_per_image_one_thread``) on
  one, as a worker process maps;
- ``stream_images_per_s``: the configured loader consumed flat out for
  ``--seconds``; with it the CPU this process spent per batch
  (``process_cpu_ms_per_batch``: the mappers' too where they are threads,
  the receiving of results where they are processes) and that of the
  loader's producer thread (``producer_cpu_ms_per_batch``);
- ``ops_per_s``: this thread's rate of small torch ops on ``--device``
  (``cuda`` by default; ``cpu`` times CPU ops, not kernel launches) alone
  (the loader idle, its queue full) and while a second thread takes
  batches from the loader at ``--batch-rate`` batches a second, in three
  turns of each over ``--seconds`` in all: the medians, and the ratio
  ``op_rate_share`` (``op_rate_shares``: of each turn).

A CUDA device synchronises every 256 ops, so that the launch queue stays
short. The numbers are of the host the probe runs on; nothing here is
timed on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import threading
import time

import torch

OPS_PER_SYNC = 256
ROUNDS = 3
SETTLE_S = 2.0


def read_config(config_file: str, root: str, opts):
    import yaml

    from u2seg_torch.config import load_config

    with open(config_file) as f:
        raw = yaml.safe_load(f) or {}
    if any("." in k for k in raw):
        flat = [f"{k}={json.dumps(v)}" for k, v in raw.items()
                if k not in ("source", "reduced", "assumed")]
        return load_config(None, flat + list(opts) + [f"datasets.root={root}"])
    return load_config(config_file, list(opts) + [f"datasets.root={root}"])


def with_workers(cfg, n: int):
    import dataclasses

    return dataclasses.replace(cfg, dataloader=dataclasses.replace(cfg.dataloader,
                                                                   num_workers=n))


def thread_cpu_s(thread: threading.Thread) -> float:
    """CPU time of a thread of this process."""
    return time.clock_gettime(time.pthread_getcpuclockid(thread.ident))


def op_rate(device: torch.device, seconds: float) -> float:
    """Small torch ops a second on this thread."""
    x = torch.ones(64, device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(OPS_PER_SYNC // 2):
            x = x * 1.0001
            x = x - 1e-4
        sync()
        n += OPS_PER_SYNC
    return n / (time.perf_counter() - t0)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--root", required=True)
    p.add_argument("--images", type=int, default=16)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--batch-rate", type=float, default=4.0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default="")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)

    from u2seg_torch.data import loader as loader_mod
    from u2seg_torch.tools import train_net

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to time CPU ops")
    cfg = read_config(args.config_file, args.root, args.opts)
    device = torch.device(args.device)
    per_batch = cfg.solver.ims_per_batch
    out = {"config": os.path.basename(args.config_file), "device": args.device,
           "ims_per_batch": per_batch, "num_workers": cfg.dataloader.num_workers,
           "torch_threads": torch.get_num_threads(), "cpus": os.cpu_count()}
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)

    inline = train_net.build_train_loader(with_workers(cfg, 0))
    next(inline)                                       # imports and first reads
    batches = max(1, args.images // per_batch)
    threads = torch.get_num_threads()
    for key, n_threads in (("map_ms_per_image", threads), ("map_ms_per_image_one_thread", 1)):
        torch.set_num_threads(n_threads)
        w0, c0 = time.perf_counter(), time.process_time()
        for _ in range(batches):
            next(inline)
        n = batches * per_batch
        out[key] = {"wall": (time.perf_counter() - w0) * 1e3 / n,
                    "cpu": (time.process_time() - c0) * 1e3 / n}
    torch.set_num_threads(threads)

    stream = train_net.build_train_loader(cfg)
    next(stream)
    producer = getattr(stream, "thread", None)
    p0 = thread_cpu_s(producer) if producer is not None else 0.0
    w0, c0, got = time.perf_counter(), time.process_time(), 0
    while time.perf_counter() - w0 < args.seconds:
        next(stream)
        got += 1
    wall = time.perf_counter() - w0
    out["stream_images_per_s"] = got * per_batch / wall
    out["process_cpu_ms_per_batch"] = (time.process_time() - c0) * 1e3 / got
    if producer is not None:
        out["producer_cpu_ms_per_batch"] = (thread_cpu_s(producer) - p0) * 1e3 / got

    go, stop, taken = threading.Event(), threading.Event(), [0]

    def consume():
        period = 1.0 / args.batch_rate
        while not stop.is_set():
            if not go.wait(0.1):
                continue
            t_next = time.perf_counter()
            while go.is_set():
                next(stream)
                taken[0] += 1
                t_next += period
                time.sleep(max(0.0, t_next - time.perf_counter()))

    consumer = threading.Thread(target=consume, daemon=True)
    consumer.start()
    alone, streaming, rates = [], [], []
    try:
        for _ in range(ROUNDS):           # alone and streaming in turns
            time.sleep(SETTLE_S)          # the loader fills its queue and idles
            alone.append(op_rate(device, args.seconds / ROUNDS))
            go.set()
            n0, t0 = taken[0], time.perf_counter()
            streaming.append(op_rate(device, args.seconds / ROUNDS))
            rates.append((taken[0] - n0) / (time.perf_counter() - t0))
            go.clear()
    finally:
        stop.set()
        go.clear()
        consumer.join(60)
    out["ops_per_s_alone"] = statistics.median(alone)
    out["ops_per_s_streaming"] = statistics.median(streaming)
    out["batches_taken_per_s"] = statistics.median(rates)
    out["op_rate_share"] = out["ops_per_s_streaming"] / out["ops_per_s_alone"]
    out["op_rate_shares"] = [s / a for s, a in zip(streaming, alone)]
    counts = getattr(loader_mod, "COUNTS", None)
    if counts is not None:
        out["loader_counts"] = dict(zip(("in_workers", "in_thread", "ready", "calls"),
                                        counts.args()))
    for it in (stream, inline):
        getattr(it, "close", lambda: None)()
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
    return out


if __name__ == "__main__":
    main()
