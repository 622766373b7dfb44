"""Trainer hooks (counterpart of ``u2seg_tpu/engine/hooks.py``).

A hook sees the trainer at four points: before and after training, before
and after each step. ``IterationTimer`` times the steps, ``PeriodicWriter``
calls the event writers, ``PeriodicCheckpointer`` and ``BestCheckpointer``
save, ``LRLogger`` records the schedule's rate, ``EvalHook`` runs an
evaluation function, ``ProfilerHook`` traces chosen iterations with
``torch.profiler`` and ``MemoryStatsHook`` records the CUDA allocator's
counters.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, List, Optional

import torch

logger = logging.getLogger(__name__)


class HookBase:
    trainer = None  # set by TrainerBase.register_hooks

    def before_train(self):
        pass

    def after_train(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass

    def state_dict(self):
        return {}

    def load_state_dict(self, state):
        pass


class IterationTimer(HookBase):
    """Puts each step's wall time as ``time``, after ``warmup_iter`` steps.
    A step's time ends in the hooks after it: the trainer's ``run_step``
    reads its metrics back to the host, so the step's device work is done."""

    def __init__(self, warmup_iter: int = 3):
        self._warmup = warmup_iter
        self._start = None
        self._step_start = None
        self._total = 0.0
        self._count = 0

    def before_train(self):
        self._start = time.perf_counter()

    def before_step(self):
        self._step_start = time.perf_counter()

    def after_step(self):
        dt = time.perf_counter() - self._step_start
        if self.trainer.iter >= self.trainer.start_iter + self._warmup:
            self.trainer.storage.put_scalar("time", dt, smoothing_hint=True)
            self._total += dt
            self._count += 1

    def after_train(self):
        total = time.perf_counter() - self._start
        if self._count:
            logger.info("Total training time: %.1fs (%.4f s/iter pure compute)",
                        total, self._total / self._count)


class PeriodicWriter(HookBase):
    def __init__(self, writers: List, period: int = 20):
        self._writers = writers
        self._period = period

    def after_step(self):
        if (self.trainer.iter + 1) % self._period == 0 or (
                self.trainer.iter == self.trainer.max_iter - 1):
            for w in self._writers:
                w.write(self.trainer.storage)

    def after_train(self):
        for w in self._writers:
            w.write(self.trainer.storage)
            w.close()


class PeriodicCheckpointer(HookBase):
    def __init__(self, checkpointer, period: int):
        self._ckptr = checkpointer
        self._period = period

    def after_step(self):
        it = self.trainer.iter
        if (it + 1) % self._period == 0 or it == self.trainer.max_iter - 1:
            self._ckptr.save(f"model_{it:07d}", self.trainer.save_state())


class BestCheckpointer(HookBase):
    """Save ``model_best`` when a validation metric improves."""

    def __init__(self, eval_period: int, checkpointer, val_metric: str,
                 mode: str = "max"):
        self._period = eval_period
        self._ckptr = checkpointer
        self._metric = val_metric
        self._mode = mode
        self._best: Optional[float] = None

    def after_step(self):
        it = self.trainer.iter
        if self._period <= 0 or (it + 1) % self._period != 0:
            return
        latest = self.trainer.storage.latest().get(self._metric)
        if latest is None:
            return
        value = latest[0]
        better = (self._best is None
                  or (self._mode == "max" and value > self._best)
                  or (self._mode == "min" and value < self._best))
        if better:
            self._best = value
            self._ckptr.save("model_best", self.trainer.save_state())

    def state_dict(self):
        return {"best": self._best}

    def load_state_dict(self, state):
        self._best = state.get("best")


class LRLogger(HookBase):
    """Puts the schedule's rate at the current iteration as ``lr`` (the
    optimizer applies the schedule itself)."""

    def __init__(self, schedule: Callable[[int], float]):
        self._schedule = schedule

    def after_step(self):
        self.trainer.storage.put_scalar(
            "lr", float(self._schedule(self.trainer.iter)), smoothing_hint=False)


class EvalHook(HookBase):
    def __init__(self, eval_period: int, eval_fn: Callable[[], dict],
                 eval_after_train: bool = True):
        self._period = eval_period
        self._fn = eval_fn
        self._after_train = eval_after_train

    def _do_eval(self):
        results = self._fn()
        if results:
            for k, v in flatten_results_dict(results).items():
                self.trainer.storage.put_scalar(k, v, smoothing_hint=False)

    def after_step(self):
        it = self.trainer.iter
        if self._period > 0 and (it + 1) % self._period == 0 and (
                it != self.trainer.max_iter - 1):
            self._do_eval()

    def after_train(self):
        if self._after_train and self.trainer.iter + 1 >= self.trainer.max_iter:
            self._do_eval()


def flatten_results_dict(results: dict, prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": float}; values that are not numbers drop."""
    out = {}
    for k, v in results.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_results_dict(v, key))
        else:
            try:
                out[key] = float(v)
            except (TypeError, ValueError):
                pass
    return out


class ProfilerHook(HookBase):
    """``torch.profiler`` over the iterations where ``enable_predicate(iter)``
    is true; each window is written as a Chrome trace into ``output_dir``."""

    def __init__(self, enable_predicate: Callable[[int], bool], output_dir: str):
        self._pred = enable_predicate
        self._dir = output_dir
        self._prof = None
        self._first = 0

    def before_step(self):
        if self._prof is None and self._pred(self.trainer.iter):
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._first = self.trainer.iter

    def _stop(self):
        self._prof.__exit__(None, None, None)
        os.makedirs(self._dir, exist_ok=True)
        path = os.path.join(self._dir, f"trace_{self._first:07d}-"
                                       f"{self.trainer.iter:07d}.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        logger.info("wrote profiler trace to %s", path)

    def after_step(self):
        if self._prof is not None and not self._pred(self.trainer.iter + 1):
            self._stop()

    def after_train(self):
        if self._prof is not None:
            self._stop()


class MemoryStatsHook(HookBase):
    """Every ``period`` iterations, the CUDA allocator's bytes in use and
    peak (MiB) on the trainer's device; nothing for a CPU device."""

    def __init__(self, period: int = 20):
        self._period = period

    def after_step(self):
        if (self.trainer.iter + 1) % self._period:
            return
        device = torch.device(self.trainer.device)
        if device.type != "cuda":
            return
        stats = torch.cuda.memory_stats(device)
        storage = self.trainer.storage
        storage.put_scalar("mem_mb", stats.get("allocated_bytes.all.current", 0)
                           / 2 ** 20, smoothing_hint=False)
        storage.put_scalar("peak_mem_mb", stats.get("allocated_bytes.all.peak", 0)
                           / 2 ** 20, smoothing_hint=False)
