"""The training step on one device (counterpart of
``u2seg_tpu/engine/trainer.py``: ``Batch``, ``create_train_state``,
``make_train_step``).

One step is: forward in training mode (the loss dict), backward, then the
optimizer's update (clipping, weight decay, momentum, scheduled LR). BatchNorm
running statistics move inside the forward. The JAX package runs this step as
one SPMD program over a device mesh and averages gradients, losses and batch
statistics over its ``data`` axis; the port's step is the single-device body,
and data parallelism is a separate layer around it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from u2seg_torch.config import Config
from u2seg_torch.models.build import build_model
from u2seg_torch.models.panoptic_fpn import PanopticFPN
from u2seg_torch.solver import ScheduledSGD, build_optimizer
from u2seg_torch.structures.instances import GtInstances


@dataclasses.dataclass
class Batch:
    """One training batch."""

    images: torch.Tensor        # (B, H, W, 3) raw RGB
    image_sizes: torch.Tensor   # (B, 2)
    gt: GtInstances             # batched, fixed capacity
    sem_seg: torch.Tensor       # (B, H, W) int labels, 255 = ignore

    def to(self, device) -> "Batch":
        return Batch(self.images.to(device), self.image_sizes.to(device),
                     self.gt.to(device), self.sem_seg.to(device))


@dataclasses.dataclass
class TrainState:
    model: PanopticFPN
    optimizer: ScheduledSGD

    @property
    def step(self) -> int:
        """Updates done so far (the optimizer keeps the count)."""
        return self.optimizer.param_groups[0]["count"]


def create_train_state(cfg: Config, device=None, seed: int = 0) -> TrainState:
    """Seeded model in training mode on ``device`` (``cuda`` unless the caller
    names another) and its optimizer."""
    model = build_model(cfg, device=device, seed=seed).train()
    return TrainState(model, build_optimizer(cfg.solver, model))


def make_train_step(
    model: PanopticFPN, optimizer: ScheduledSGD,
) -> Callable[[Batch, Optional[torch.Generator]], Dict[str, torch.Tensor]]:
    """-> ``step(batch, generator)``: one update of ``model`` by
    ``optimizer``; returns the losses and their sum ``total_loss`` (detached
    0-dim tensors on the model's device). ``generator`` feeds the fg/bg
    sampling of the RPN and the ROI heads."""

    def step(batch: Batch, generator: Optional[torch.Generator] = None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        losses = model(batch.images, batch.image_sizes, gt=batch.gt,
                       sem_seg_gt=batch.sem_seg, train=True,
                       generator=generator)
        total = sum(losses.values())
        total.backward()
        optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        return metrics

    return step
