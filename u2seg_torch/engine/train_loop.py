"""Hook-driven training loop (counterpart of ``u2seg_tpu/engine/train_loop.py``).

``TrainerBase`` runs the loop and calls the hooks around each step.
``DefaultTrainer`` wires model, optimizer, checkpointer and the default hooks
from a ``Config`` and runs ``make_train_step`` over a data loader of mapper
dicts. With a process group of N > 1 each process takes its contiguous
share of every global batch, parameters and buffers start as rank 0's, and
the step averages gradients, losses and BatchNorm statistics, so every
process holds the same model after every step. Only rank 0 writes
``metrics.json`` and checkpoints.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
import weakref
from typing import Iterable, List, Optional

import numpy as np
import torch

from u2seg_torch.config import Config
from u2seg_torch.data.loader import COUNTS as loader_counts
from u2seg_torch.engine import hooks as hooks_lib
from u2seg_torch.engine.checkpoint import Checkpointer, load_model_weights
from u2seg_torch.engine.events import CommonMetricPrinter, EventStorage, JSONWriter
from u2seg_torch.engine.trainer import (
    Batch, create_train_state, make_train_step, sampling_seed,
)
from u2seg_torch.parallel import comm
from u2seg_torch.parallel.mesh import create_mesh, shard_batch
from u2seg_torch.solver import build_lr_schedule
from u2seg_torch.structures.instances import GtInstances
from u2seg_torch.utils.spans import GcSpans, span

logger = logging.getLogger(__name__)


class TrainerBase:
    def __init__(self):
        self._hooks: List[hooks_lib.HookBase] = []
        self.iter = 0
        self.start_iter = 0
        self.max_iter = 0
        self.storage: Optional[EventStorage] = None

    def register_hooks(self, hooks: Iterable[Optional[hooks_lib.HookBase]]):
        for h in hooks:
            if h is None:
                continue
            h.trainer = weakref.proxy(self)
            self._hooks.append(h)

    def train(self, start_iter: int, max_iter: int):
        self.iter = self.start_iter = start_iter
        self.max_iter = max_iter
        with EventStorage(start_iter) as self.storage, GcSpans():
            try:
                self.before_train()
                for self.iter in range(start_iter, max_iter):
                    with span("u2s.step", self.iter):
                        self.storage.iter = self.iter
                        self.before_step()
                        self.run_step()
                        self.after_step()
                self.iter += 1
            finally:
                self.after_train()

    def before_train(self):
        for h in self._hooks:
            h.before_train()

    def after_train(self):
        if self.storage is not None:
            self.storage.iter = self.iter
        for h in self._hooks:
            h.after_train()

    def before_step(self):
        for h in self._hooks:
            with span("u2s.hook." + type(h).__name__):
                h.before_step()

    def after_step(self):
        for h in self._hooks:
            with span("u2s.hook." + type(h).__name__):
                h.after_step()

    def run_step(self):
        raise NotImplementedError

    def state_dict(self):
        return {
            "iteration": self.iter,
            "hooks": {type(h).__name__: h.state_dict()
                      for h in self._hooks if h.state_dict()},
        }


def batch_from_numpy(b: dict) -> Batch:
    """Stacked mapper output (numpy arrays) -> ``Batch`` of CPU tensors."""
    images = torch.from_numpy(np.asarray(b["image"]))
    sem = b.get("sem_seg")
    if sem is None:
        sem = np.zeros(images.shape[:3], np.int32)
    masks = b.get("gt_masks")
    return Batch(
        images=images,
        image_sizes=torch.from_numpy(np.asarray(b["image_size"])),
        gt=GtInstances(
            boxes=torch.from_numpy(np.asarray(b["gt_boxes"])),
            classes=torch.from_numpy(np.asarray(b["gt_classes"])),
            valid=torch.from_numpy(np.asarray(b["gt_valid"])),
            masks=None if masks is None else torch.from_numpy(np.asarray(masks))),
        sem_seg=torch.from_numpy(np.asarray(sem)),
    )


class DefaultTrainer(TrainerBase):
    """Config-driven data-parallel trainer.

    ``data_loader`` yields global batches as mapper dicts (``image``,
    ``image_size``, ``gt_boxes``, ``gt_classes``, ``gt_valid``, optional
    ``gt_masks`` and ``sem_seg``), of which each process takes its rows;
    with ``sharded_loader`` it yields this process's own rows (a loader
    sharded by rank, as ``tools/train_net.py`` builds it). ``mesh`` defaults
    to ``create_mesh(device)``: the default process group, on ``cuda``
    unless ``device`` names another. Each step's sampling generator is
    seeded from (seed + 1, rank, update count), so a resumed run continues
    the uninterrupted one bit for bit.
    """

    def __init__(self, cfg: Config, data_loader: Iterable[dict], mesh=None,
                 device=None, sharded_loader: bool = False):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else create_mesh(device)
        self.device = self.mesh.device
        self._loader = iter(data_loader)
        self._sharded_loader = sharded_loader
        self.schedule = build_lr_schedule(cfg.solver)
        self.seed = cfg.seed if cfg.seed >= 0 else 0
        self.state = create_train_state(cfg, device=self.device, seed=self.seed)
        # every process starts from rank 0's parameters and buffers
        comm.broadcast_(list(self.model.state_dict().values()), src=0)
        self.step_fn = make_train_step(self.model, self.optimizer, self.mesh)
        self._generator = torch.Generator(device=self.device)
        self.checkpointer = Checkpointer(cfg.output_dir)

    @property
    def model(self):
        return self.state.model

    @property
    def optimizer(self):
        return self.state.optimizer

    # -- checkpoint plumbing ------------------------------------------
    def save_state(self):
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "iteration": self.iter}

    def resume_or_load(self, resume: bool = True) -> bool:
        """Resume from the newest checkpoint of ``output_dir`` when
        ``resume`` and there is one; otherwise load ``cfg.model.weights``
        (when set) into the model and start at iteration 0."""
        restored, resumed = self.checkpointer.resume_or_load(
            None, resume, map_location=self.device)
        if resumed:
            self.model.load_state_dict(restored["model"])
            self.optimizer.load_state_dict(restored["optimizer"])
            self.start_iter = int(restored["iteration"]) + 1
        elif self.cfg.model.weights:
            load_model_weights(self.model, self.cfg.model.weights)
        return resumed

    # -- loop ---------------------------------------------------------
    def _next_batch_raw(self) -> dict:
        return next(self._loader)

    def run_step(self):
        with span("u2s.data", loader_counts.args()):
            raw = self._next_batch_raw()
        with span("u2s.upload"):
            batch = batch_from_numpy(raw)
            batch = (batch.to(self.device) if self._sharded_loader
                     else shard_batch(self.mesh, batch))
        self._generator.manual_seed(
            sampling_seed(self.seed + 1, self.mesh.rank, self.state.step))
        metrics = self.step_fn(batch, self._generator)
        with span("u2s.metrics"):
            # one host transfer of the (already averaged) metrics
            values = torch.stack([v.float() for v in metrics.values()]).tolist()
            metrics = dict(zip(metrics, values))
            if not math.isfinite(metrics.get("total_loss", 0.0)):
                raise FloatingPointError(
                    f"Loss became infinite or NaN at iteration={self.iter}! "
                    f"metrics={metrics}")
            self.storage.put_scalars(**metrics, smoothing_hint=True)

    def build_hooks(self) -> List[hooks_lib.HookBase]:
        cfg = self.cfg
        hooks = [
            hooks_lib.IterationTimer(),
            hooks_lib.LRLogger(self.schedule),
            hooks_lib.PeriodicCheckpointer(self.checkpointer,
                                           cfg.solver.checkpoint_period),
        ]
        if comm.is_main_process():
            hooks.append(hooks_lib.PeriodicWriter([
                CommonMetricPrinter(cfg.solver.max_iter),
                JSONWriter(os.path.join(cfg.output_dir, "metrics.json")),
            ], period=20))
        return hooks

    def train(self, max_iter: Optional[int] = None):
        max_iter = max_iter or self.cfg.solver.max_iter
        super().train(self.start_iter, max_iter)


def auto_scale_workers(cfg: Config, num_workers: int) -> Config:
    """Scale LR and iteration counts from the reference 8-worker recipe to
    ``num_workers``. Returns a new Config."""
    old_world = 8
    if num_workers == old_world:
        return cfg
    scale = num_workers / old_world
    s = cfg.solver
    new_solver = dataclasses.replace(
        s,
        base_lr=s.base_lr * scale,
        max_iter=int(round(s.max_iter / scale)),
        warmup_iters=int(round(s.warmup_iters / scale)),
        steps=tuple(int(round(x / scale)) for x in s.steps),
    )
    return dataclasses.replace(cfg, solver=new_solver)
