"""Training traffic: ``DefaultTrainer`` steps as ``tools/train_net.py`` sets
them up, fed by the port's train loader from files drawn from the seed.

Set-up writes the files, builds the loader and the trainer (its seeded
model, optimizer and default hooks), and drives the trainer from the seed
through its first ``compare_steps`` steps through the loop's own call and
feed; those are the steps the reference follows. Then every pad bucket of
the configuration is warmed by two steps of ``step_fn`` on a batch padded to
it, and the window opens: the loop runs until ``--seconds`` have passed at
the end of a step. With ``--trace 1`` the profiler covers ``trace_steps``
steps of the window, after its first two.

Once the window has closed and the peak memory is read, the trainer is
freed and the reference replays the compared steps (``reference_train``).
"""
from __future__ import annotations

import gc
import os
import sys
import time
from typing import Dict, List

import numpy as np

from portbench import counts, reference_train, traffic
from portbench.devtrace import Profiler
from portbench.record import Record

# the port's loader seeds ``RandomState(seed * 1000 + rank)``, which takes
# no more than 32 bits: the run's seed reaches the program through this
PROGRAM_SEEDS = 4_000_000


def program_seed(seed: int) -> int:
    return seed % PROGRAM_SEEDS


class WindowClosed(Exception):
    """Raised by the window hook to end the loop."""


class Feed:
    """The trainer's loader, timed: the host time of every ``next()`` (the
    step's wait for data), the bucket of every batch, and the first
    ``keep`` batches kept for the reference."""

    def __init__(self, loader, keep: int):
        self.loader, self.keep = loader, keep
        self.waits: List[float] = []
        self.buckets: List[tuple] = []
        self.kept: List[dict] = []
        self._peeked = None

    def __iter__(self):
        return self

    def peek(self) -> dict:
        """The next batch, which the next ``next()`` hands out."""
        if self._peeked is None:
            self._peeked = next(self.loader)
        return self._peeked

    def __next__(self):
        from torch.profiler import record_function

        with record_function("pb.data_wait"):
            t0 = time.perf_counter()
            if self._peeked is not None:
                b, self._peeked = self._peeked, None
            else:
                b = next(self.loader)
            self.waits.append(time.perf_counter() - t0)
        self.buckets.append(tuple(np.asarray(b["image"]).shape[1:3]))
        if len(self.kept) < self.keep:
            self.kept.append({k: np.array(v, copy=True) if isinstance(v, np.ndarray) else v
                              for k, v in b.items()})
        return b

    def close(self):
        getattr(self.loader, "close", lambda: None)()


def repad(b: dict, bucket) -> dict:
    """``b`` padded (or cut) to ``bucket``: images with zeros, the stuff map
    with the ignore label, sizes and boxes cut to what stays."""
    bh, bw = bucket
    img = np.asarray(b["image"])
    n, h, w = img.shape[:3]
    hh, ww = min(h, bh), min(w, bw)
    out = dict(b)
    out["image"] = np.zeros((n, bh, bw, 3), img.dtype)
    out["image"][:, :hh, :ww] = img[:, :hh, :ww]
    sem = np.full((n, bh, bw), 255, np.asarray(b["sem_seg"]).dtype)
    sem[:, :hh, :ww] = np.asarray(b["sem_seg"])[:, :hh, :ww]
    out["sem_seg"] = sem
    size = np.minimum(np.asarray(b["image_size"]), [bh, bw]).astype(np.int32)
    out["image_size"] = size
    boxes = np.asarray(b["gt_boxes"]).copy()
    boxes[..., 0::2] = np.minimum(boxes[..., 0::2], size[:, None, 1:2] - 1)
    boxes[..., 1::2] = np.minimum(boxes[..., 1::2], size[:, None, 0:1] - 1)
    out["gt_boxes"] = boxes
    out["gt_valid"] = np.asarray(b["gt_valid"]) & (boxes[..., 2] > boxes[..., 0] + 1) & (
        boxes[..., 3] > boxes[..., 1] + 1)
    return out


class K3Recorder:
    """Counts the least bytes of every pooler backward (K3) that the traced
    steps launch: each training pool of the ROI heads runs one."""

    def __init__(self):
        from u2seg_torch.models import roi_heads

        self.module = roi_heads
        self.inner = roi_heads.multilevel_roi_align_train
        self.on = False
        self.bytes = 0
        self.calls = 0

    def __call__(self, features, boxes, batch_idx, output_size, strides, *a, **k):
        if self.on:
            b, c = features[0].shape[0], features[0].shape[-1]
            self.bytes += counts.k3_bytes([tuple(f.shape[1:3]) for f in features], b, c,
                                          boxes.shape[0], output_size)
            self.calls += 1
        return self.inner(features, boxes, batch_idx, output_size, strides, *a, **k)

    def __enter__(self):
        self.module.multilevel_roi_align_train = self
        return self

    def __exit__(self, *exc):
        self.module.multilevel_roi_align_train = self.inner
        return False


def forget_datasets(names) -> None:
    """Drop earlier registrations of ``names`` (and their ``_stuffonly``
    views) from the port's catalogs: ``register_all_coco`` keeps the first
    root a name was registered under, and a process may drive several runs
    (the calibration, the tests)."""
    from u2seg_torch.data.catalog import DatasetCatalog, MetadataCatalog

    for name in names:
        for n in (name, name.replace("_separated", "_stuffonly")):
            if n in DatasetCatalog:
                DatasetCatalog.remove(n)
            if n in MetadataCatalog.list():
                MetadataCatalog.remove(n)


def run(ctx) -> Record:
    import torch
    from torch.profiler import record_function

    from u2seg_torch.config import load_config
    from u2seg_torch.engine.hooks import HookBase
    from u2seg_torch.engine.train_loop import DefaultTrainer, batch_from_numpy
    from u2seg_torch.tools import train_net

    tr = ctx.traffic
    n_cmp = tr["compare_steps"]
    root = os.path.join(ctx.scratch, "datasets")
    marks = [("import", time.perf_counter())]
    traffic.write_train_set(root, tr, ctx.seed)
    marks.append(("data files", time.perf_counter()))
    flat, assumed = reference_train.read_config_file(ctx.config_file)
    seed = program_seed(ctx.seed)
    run_overrides = [f"seed={seed}", f"datasets.root={root}",
                     f"output_dir={os.path.join(ctx.scratch, 'output')}"] + tr["overrides"]
    cfg = load_config(None, flat + run_overrides)
    dev = torch.device(ctx.device)
    tau = assumed["cls_score_tau"]

    forget_datasets(cfg.datasets.train)
    feed = Feed(train_net.build_train_loader(cfg), keep=n_cmp)
    trainer = DefaultTrainer(cfg, feed, device=ctx.device, sharded_loader=True)
    reference_train.scale_cls_score(trainer.model, tau)
    first = feed.peek() if assumed.get("frozen_norms_from_first_batch") else None
    if first is not None:
        reference_train.calibrate_frozen_norms(
            trainer.model, batch_from_numpy(first).images.to(dev))
    marks.append(("loader and trainer", time.perf_counter()))
    snap = reference_train.Snapshot(trainer.model, trainer.optimizer, n_cmp)
    k3 = K3Recorder() if ctx.trace and dev.type == "cuda" else None
    inner_step = trainer.step_fn

    def step_fn(batch, generator=None):
        with record_function("pb.train_step"):
            return inner_step(batch, generator)

    trainer.step_fn = step_fn
    inner_run_step = trainer.run_step

    def run_step():
        with record_function("pb.run_step"):
            inner_run_step()

    trainer.run_step = run_step
    # the compared steps' RPN head outputs and proposals: the reference's ROI
    # heads sample from the program's proposals, and its proposal stage is
    # checked by itself on the program's head outputs
    heads, props = [], []
    rpn = trainer.model.proposal_generator
    hooks = [rpn.rpn_head.register_forward_hook(
                 lambda m, i, out: heads.append(tuple([t.detach() for t in x] for x in out))),
             rpn.register_forward_hook(
                 lambda m, i, out: props.append((out.proposal_boxes.detach(),
                                                 out.proposal_scores.detach(),
                                                 out.proposal_valid)))]
    state: Dict[str, object] = {"phase": "compare"}
    times: List[tuple] = []                  # (start, end, images) of window steps
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def warm_up() -> None:
        """Two steps at every bucket, on the first kept batch padded to it."""
        gen = torch.Generator(device=dev)
        for bucket in cfg.input.pad_buckets:
            for _ in range(2):
                gen.manual_seed(0)
                trainer.step_fn(batch_from_numpy(repad(feed.kept[0], bucket)).to(dev), gen)
        sync()

    class Window(HookBase):
        def before_step(self):
            it = self.trainer.iter
            if it == 0:
                snap.start()
            self._t = time.perf_counter()
            if state["phase"] == "window" and not times:
                state["t_open"] = self._t
                state["wait_from"] = len(feed.waits)
            if state["phase"] == "window" and prof is not None and len(times) == 2:
                # the profiler's start counts in the first traced step
                if k3 is not None:
                    k3.on = True
                prof.__enter__()

        def after_step(self):
            it = self.trainer.iter
            if state["phase"] == "compare":
                hist = self.trainer.storage.latest()
                snap.after_step(it, {k: float(v[0]) for k, v in hist.items()
                                     if k.startswith("loss") or k == "total_loss"})
                if it == n_cmp - 1:
                    for h in hooks:
                        h.remove()
                    marks.append(("compared steps", time.perf_counter()))
                    warm_up()
                    marks.append(("warm-up", time.perf_counter()))
                    state["phase"] = "window"
                return
            t = time.perf_counter()
            times.append((self._t, t, cfg.solver.ims_per_batch))
            if prof is not None and len(times) == 2 + trace_steps:
                prof.__exit__(None, None, None)
                if k3 is not None:
                    k3.on = False
            # a traced run's window holds at least one untraced step after
            # the traced ones
            if t - state["t_open"] >= ctx.seconds and (
                    prof is None or len(times) > 2 + trace_steps):
                raise WindowClosed

    trace_steps = tr["trace_steps"]
    prof = Profiler(ctx.device) if ctx.trace else None
    trainer.register_hooks(trainer.build_hooks() + [Window()])
    trainer.resume_or_load(resume=False)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        if k3 is not None:
            with k3:
                trainer.train()
        else:
            trainer.train()
    except WindowClosed:
        pass
    finally:
        feed.close()
    sync()
    t_close = times[-1][1]
    print("set-up, s: " + ", ".join(f"{name} {t - prev:.2f}" for (name, t), (_, prev) in
                                   zip(marks, [("start", ctx.t0)] + marks)),
          file=sys.stderr, flush=True)
    step_ms = sorted(1e3 * (e - s) for s, e, _ in times)
    half = len(times) // 2
    print(f"window: {len(times)} steps, step ms q1/median/q3 "
          f"{step_ms[len(step_ms) // 4]:.1f}/{step_ms[len(step_ms) // 2]:.1f}/"
          f"{step_ms[3 * len(step_ms) // 4]:.1f}, max {step_ms[-1]:.1f}; halves "
          f"{times[half - 1][1] - times[0][0]:.2f} s / {times[-1][1] - times[half][0]:.2f} s"
          if half else f"window: {len(times)} steps", file=sys.stderr, flush=True)
    peak = int(torch.cuda.max_memory_allocated()) if dev.type == "cuda" else 0
    window_steps = len(times)
    images = sum(n for _, _, n in times)
    waits = feed.waits[state["wait_from"]:state["wait_from"] + window_steps]
    # each window step's pad bucket (steps fetch their batch in order)
    buckets = feed.buckets[state["wait_from"]:state["wait_from"] + window_steps]
    record = Record(kind="train", setup_s=state["t_open"] - ctx.t0,
                    window_s=t_close - state["t_open"], images=images, steps=window_steps,
                    attempted=images, failed=0, memory_peak_bytes=peak,
                    data_wait_s=list(waits), compute_dtype=cfg.model.compute_dtype)
    program = snap.readings
    program.rpn_heads = heads
    kept = feed.kept
    untraced = []
    if prof is not None:
        # the traced steps are window steps 2 .. 2 + trace_steps - 1; the
        # untraced ones, the profiler's start and end outside them, time the
        # steps as the untraced program runs them
        end = 2 + trace_steps
        record.trace, record.traced_steps = prof.trace, trace_steps
        record.untraced_s = (times[2][0] - state["t_open"]) + (t_close - times[end][0])
        record.untraced_steps = window_steps - trace_steps
        untraced = buckets[:2] + buckets[end:]
        traced_ms = 1e3 * (times[end - 1][1] - times[2][0]) / trace_steps
        print(f"traced steps {traced_ms:.1f} ms a step, untraced "
              f"{1e3 * record.untraced_s / record.untraced_steps:.1f}",
              file=sys.stderr, flush=True)
        if k3 is not None:
            record.k3_bytes, record.k3_calls = float(k3.bytes), k3.calls
    del trainer, snap, inner_step, step_fn, inner_run_step, run_step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the program is freed
    ref_cfg = reference_train.load_reference_config(ctx.config_file, run_overrides)
    numbers = {"proposal_gap": max(
        reference_train.proposal_gap(p, reference_train.proposals_from_heads(
            ref_cfg, lg, dl, torch.from_numpy(np.asarray(b["image_size"])), dev))
        if p[0].shape[0] == len(b["image_size"]) else 1.0
        for p, (lg, dl), b in zip(props, heads, kept))}
    norms_from = kept[0] if first is not None else None
    reference = reference_train.replay(ref_cfg, seed, tau, kept, dev, proposals=props,
                                       frozen_norms_from=norms_from)
    # the same reference at the configuration's own precision (bf16 in the
    # cells), which the numbers ending in _bf16 compare with
    own = cfg.model.compute_dtype
    reference16 = reference if own == "float32" else reference_train.replay(
        reference_train.own_precision(ref_cfg, own), seed, tau, kept, dev, proposals=props,
        frozen_norms_from=norms_from)
    numbers.update(reference_train.compare_both(program, reference, reference16))
    record.extra = {"numbers": numbers, "program": program, "reference": reference,
                    "reference16": reference16, "kept": kept, "proposals": props,
                    "ref_cfg": ref_cfg, "compute_dtype": own, "seed": seed, "tau": tau,
                    "frozen_norms_from": norms_from}
    print("numbers: " + ", ".join(f"{k} {v:.6g}" for k, v in sorted(numbers.items())
                                  if "_part." not in k), file=sys.stderr, flush=True)
    # the numbers compared are those the workload gives a limit
    limits = tr["limits"]
    record.checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    record.correct = (reference_train.finite(program)
                      and all(numbers[k] <= v for k, v in limits.items()))
    if prof is not None:
        record.untraced_flops = step_flops(ref_cfg, seed, tau, kept[0], untraced, dev)
    return record


def step_flops(ref_cfg, seed: int, tau: float, batch: dict, buckets, dev) -> float:
    """FLOPs of training steps at ``buckets`` (one per step), counted on the
    reference model at each bucket."""
    import torch

    model = reference_train.build_reference(ref_cfg, seed, tau, dev).train()
    gen = torch.Generator(device=dev)
    per_bucket = {}
    for bucket in sorted(set(buckets)):
        gen.manual_seed(0)
        b = reference_train.batch_from_arrays(repad(batch, bucket), dev)
        per_bucket[bucket] = counts.train_step_flops(model, b, gen)
    return float(sum(per_bucket[bk] for bk in buckets))
