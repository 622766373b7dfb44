"""ViTDet training traffic: ``DefaultTrainer`` steps as ``tools/train_net.py``
sets them up, as ``drivers/train.py`` drives them, held against the ViTDet
reference (``portbench.refvitdet``).

Set-up reads the configuration (a port that lacks its fields fails here,
before anything is written), writes the files, builds the loader and the
trainer (its seeded model, AdamW and default hooks), and drives the trainer
from the seed through its first ``compare_steps`` steps; those are the steps
the reference replays, on the same batches, the same stochastic-depth and
sampling draws and the program's proposals. Then the pad bucket is warmed by
two steps and the window opens: the loop runs until ``--seconds`` have
passed at the end of a step. With ``--trace 1`` the profiler covers
``trace_steps`` steps of the window after its first two, and the trace is
read with the program's spans (``spantrace.extend``), so that idle gaps and
kernels carry ``u2s.`` labels and the attention's kernels are found by the
span that launched them in the forward, and by the autograd node that the
span's ops made in the backward (``attention_backward``).

Once the window has closed and the peak memory is read, the trainer is
freed and the reference replays the compared steps, in f32 and at the
configuration's compute dtype (``refvitdet.replay``).
"""
from __future__ import annotations

import bisect
import gc
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from portbench import counts_vitdet, reference_train as rt, spantrace, traffic
from portbench.devtrace import Profiler
from portbench.drivers.train import (Feed, K3Recorder, WindowClosed, forget_datasets,
                                     program_seed, repad)
from portbench.record import Record


@dataclass
class ViTRecord(Record):
    # the attention's forward and backward FLOPs in one traced step (shapes)
    attn_flops: float = 0.0


ATTN_SPANS = "u2s.vit.attn."
EVALUATE = "autograd::engine::evaluate_function: "


@dataclass
class ViTTrace(spantrace.ProgramTrace):
    # host (start, end) ns of the backward's autograd nodes made by ops that
    # ran inside an attention span (``attention_backward``)
    attn_backward: List[Tuple[int, int]] = field(default_factory=list)


def attention_backward(events, prefix: str = ATTN_SPANS) -> List[Tuple[int, int]]:
    """The host intervals, in order, in which the autograd engine evaluated
    a node made by a forward op that ran inside a span named ``prefix...``:
    the node's function and the sums of its gradients into the next nodes'
    inputs. A node's event (``autograd::engine::evaluate_function: ...``)
    carries the sequence number and the thread of the forward op that made
    it; that op is the latest-starting op of that thread with the number
    (an op peeks at its thread's counter, the op that makes a node moves it
    on, so the ops that share the number are the maker and the ones that
    began before it)."""
    from torch.autograd import DeviceType

    spans: Dict[int, List[Tuple[int, int]]] = {}
    made: Dict[Tuple[int, int], int] = {}          # (thread, number) -> maker's start
    nodes = []
    for ev in events:
        if ev.device_type() != DeviceType.CPU:
            continue
        name, s = ev.name(), ev.start_ns()
        if name.startswith(prefix):
            spans.setdefault(ev.start_thread_id(), []).append((s, s + ev.duration_ns()))
            continue
        seq = ev.sequence_nr()
        if seq < 0:
            continue
        if name.startswith(EVALUATE):
            nodes.append((ev.fwd_thread_id(), seq, s, s + ev.duration_ns()))
        elif ev.fwd_thread_id() == 0:              # a forward op (a node names its thread)
            key = (ev.start_thread_id(), seq)
            made[key] = max(made.get(key, s), s)
    for ranges in spans.values():
        ranges.sort()

    def inside(thread: int, t: int) -> bool:
        ranges = spans.get(thread, [])
        i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
        return i >= 0 and t < ranges[i][1]

    return sorted((s, e) for thread, seq, s, e in nodes
                  if (thread, seq) in made and inside(thread, made[(thread, seq)]))


class SpanProfiler(Profiler):
    """``devtrace.Profiler`` whose trace also holds the program's spans,
    syncs and each kernel's launch (``spantrace.extend``), and the
    attention's backward nodes (``attention_backward``)."""

    def _reduce(self):
        events = self._prof.profiler.kineto_results.events()
        tr = spantrace.extend(super()._reduce(), events)
        return ViTTrace(**vars(tr), attn_backward=attention_backward(events))


def run(ctx) -> Record:
    import numpy as np
    import torch
    from torch.profiler import record_function

    from portbench.refvitdet import replay
    from u2seg_torch.config import load_config
    from u2seg_torch.engine.hooks import HookBase
    from u2seg_torch.engine.train_loop import DefaultTrainer, batch_from_numpy
    from u2seg_torch.tools import train_net

    tr = ctx.traffic
    n_cmp = tr["compare_steps"]
    root = os.path.join(ctx.scratch, "datasets")
    flat, assumed = rt.read_config_file(ctx.config_file)
    seed = program_seed(ctx.seed)
    run_overrides = [f"seed={seed}", f"datasets.root={root}",
                     f"output_dir={os.path.join(ctx.scratch, 'output')}"] + tr["overrides"]
    cfg = load_config(None, flat + run_overrides)
    marks = [("import", time.perf_counter())]
    traffic.write_train_set(root, tr, ctx.seed)
    marks.append(("data files", time.perf_counter()))
    dev = torch.device(ctx.device)
    tau = assumed["cls_score_tau"]

    forget_datasets(cfg.datasets.train)
    feed = Feed(train_net.build_train_loader(cfg), keep=n_cmp)
    trainer = DefaultTrainer(cfg, feed, device=ctx.device, sharded_loader=True)
    rt.scale_cls_score(trainer.model, tau)
    marks.append(("loader and trainer", time.perf_counter()))
    snap = replay.Snapshot(trainer.model, trainer.optimizer, n_cmp)
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
                batch = repad(replay.arrays(feed.kept[0]), bucket)
                trainer.step_fn(batch_from_numpy(batch).to(dev), gen)
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
            if t - state["t_open"] >= ctx.seconds and (
                    prof is None or len(times) > 2 + trace_steps):
                raise WindowClosed

    trace_steps = tr["trace_steps"]
    prof = SpanProfiler(ctx.device) if ctx.trace else None
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
    print(f"window: {len(times)} steps, step ms q1/median/q3 "
          f"{step_ms[len(step_ms) // 4]:.1f}/{step_ms[len(step_ms) // 2]:.1f}/"
          f"{step_ms[3 * len(step_ms) // 4]:.1f}, max {step_ms[-1]:.1f}",
          file=sys.stderr, flush=True)
    peak = int(torch.cuda.max_memory_allocated()) if dev.type == "cuda" else 0
    window_steps = len(times)
    images = sum(n for _, _, n in times)
    waits = feed.waits[state["wait_from"]:state["wait_from"] + window_steps]
    record = ViTRecord(kind="train", setup_s=state["t_open"] - ctx.t0,
                       window_s=t_close - state["t_open"], images=images, steps=window_steps,
                       attempted=images, failed=0, memory_peak_bytes=peak,
                       data_wait_s=list(waits), compute_dtype=cfg.model.compute_dtype)
    program = snap.readings
    program.rpn_heads = heads
    kept = feed.kept
    b = cfg.model.backbone
    if prof is not None:
        end = 2 + trace_steps
        record.trace, record.traced_steps = prof.trace, trace_steps
        record.untraced_s = (times[2][0] - state["t_open"]) + (t_close - times[end][0])
        record.untraced_steps = window_steps - trace_steps
        traced_ms = 1e3 * (times[end - 1][1] - times[2][0]) / trace_steps
        print(f"traced steps {traced_ms:.1f} ms a step, untraced "
              f"{1e3 * record.untraced_s / record.untraced_steps:.1f}",
              file=sys.stderr, flush=True)
        if k3 is not None:
            record.k3_bytes, record.k3_calls = float(k3.bytes), k3.calls
        grid = tuple(s // b.vit_patch_size for s in cfg.input.pad_buckets[0])
        record.attn_flops = sum(counts_vitdet.attention_flops(
            cfg.solver.ims_per_batch, grid, b.vit_dim, b.vit_num_heads, b.vit_depth,
            b.vit_window_size, tuple(b.vit_global_blocks), b.vit_use_rel_pos))
    del trainer, snap, inner_step, step_fn, inner_run_step, run_step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the program is freed
    ref_cfg = replay.load_config(ctx.config_file, run_overrides)
    numbers = {"proposal_gap": max(
        rt.proposal_gap(p, rt.proposals_from_heads(
            ref_cfg, lg, dl, torch.from_numpy(np.asarray(kb["image_size"])), dev))
        if p[0].shape[0] == len(kb["image_size"]) else 1.0
        for p, (lg, dl), kb in zip(props, heads, kept))}
    start = replay.initial_state(ref_cfg, seed, tau, dev)
    reference = replay.replay(ref_cfg, seed, tau, kept, dev, proposals=props, state=start)
    own = cfg.model.compute_dtype
    ref_own = rt.own_precision(ref_cfg, own)
    reference16 = reference if own == "float32" else replay.replay(
        ref_own, seed, tau, kept, dev, proposals=props, state=start)
    global_blocks = tuple(b.vit_global_blocks)
    numbers.update(replay.compare_both(program, reference, reference16, global_blocks))
    record.extra = {"numbers": numbers, "program": program, "reference": reference,
                    "reference16": reference16, "kept": kept, "proposals": props,
                    "ref_cfg": ref_cfg, "compute_dtype": own, "seed": seed, "tau": tau,
                    "state": start, "global_blocks": global_blocks}
    print("numbers: " + ", ".join(f"{k} {v:.6g}" for k, v in sorted(numbers.items())
                                  if "_part." not in k), file=sys.stderr, flush=True)
    limits = tr["limits"]
    record.checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    record.correct = (rt.finite(program)
                      and all(numbers[k] <= v for k, v in limits.items()))
    if prof is not None:
        record.untraced_flops = replay.step_flops(ref_own, seed, tau, kept[0],
                                                  record.untraced_steps, dev, state=start)
    return record
