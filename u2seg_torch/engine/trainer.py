"""The training step on one device and the data-parallel inference step
(counterpart of ``u2seg_tpu/engine/trainer.py``: ``Batch``,
``create_train_state``, ``make_train_step``, ``make_eval_step``).

One step is: forward in training mode (the loss dict), backward, then the
optimizer's update (clipping, weight decay, momentum, scheduled LR). BatchNorm
running statistics move inside the forward. The JAX package runs this step as
one SPMD program over a device mesh and averages gradients, losses and batch
statistics over its ``data`` axis. The port's step takes a ``Mesh`` (the
default process group, ``parallel/mesh.py``): with more than one process it
averages the gradients, the losses and the BatchNorm running statistics
over the processes in one all-reduce after the backward, before the update,
so every process applies the same update to the same parameters. With one
process it takes no collective.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from u2seg_torch.config import Config
from u2seg_torch.models.build import build_model
from u2seg_torch.models.panoptic_fpn import PanopticFPN, PanopticOutput
from u2seg_torch.ops.norms import BatchNorm2d
from u2seg_torch.parallel import comm
from u2seg_torch.solver import ScheduledSGD, build_optimizer
from u2seg_torch.structures.instances import GtInstances
from u2seg_torch.utils.spans import span


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


# the meta-architectures that train through the trainer: PanopticFPN, as in
# the JAX package (whose ``create_train_state`` builds a PanopticFPN whatever
# the config names), and GeneralizedRCNN (Faster, Mask and Cascade R-CNN),
# which the JAX package does not train: the step feeds it no ``sem_seg_gt``
TRAINABLE = ("PanopticFPN", "GeneralizedRCNN")


def check_trainable(cfg: Config) -> None:
    """Raises for a meta-architecture that the trainer cannot train."""
    name = cfg.model.meta_architecture
    if name not in TRAINABLE:
        raise ValueError(
            f"meta architecture {name!r} does not train through the trainer: "
            "only PanopticFPN and GeneralizedRCNN do")


def create_train_state(cfg: Config, device=None, seed: int = 0) -> TrainState:
    """Seeded model in training mode on ``device`` (``cuda`` unless the caller
    names another) and its optimizer. Raises ``ValueError`` for a
    meta-architecture the trainer cannot train (``check_trainable``)."""
    check_trainable(cfg)
    model = build_model(cfg, device=device, seed=seed).train()
    return TrainState(model, build_optimizer(cfg.solver, model))


def sampling_seed(seed: int, rank: int, step: int) -> int:
    """The seed of one step's sampling generator on one rank: a hash of
    (seed, rank, step), the counterpart of the JAX step's
    ``fold_in(fold_in(rng, axis_index), step)``. Ranks draw different
    samples, and a resumed run draws what an uninterrupted one would have."""
    return int(np.random.SeedSequence([seed, rank, step]).generate_state(1, np.uint64)[0])


def bn_running_stats(model: torch.nn.Module) -> List[torch.Tensor]:
    """The running mean and variance of every BatchNorm that is not frozen."""
    return [t for m in model.modules() if isinstance(m, BatchNorm2d) and not m.frozen
            for t in (m.running_mean, m.running_var)]


def make_train_step(
    model: PanopticFPN, optimizer: ScheduledSGD, mesh=None,
) -> Callable[[Batch, Optional[torch.Generator]], Dict[str, torch.Tensor]]:
    """-> ``step(batch, generator)``: one update of ``model`` by
    ``optimizer``; returns the losses and their sum ``total_loss`` (detached
    0-dim tensors on the model's device). ``generator`` feeds the fg/bg
    sampling of the RPN and the ROI heads. With a ``mesh`` of more than one
    process, ``batch`` is this process's share, and gradients, losses and
    BatchNorm running statistics are averaged over the processes (one
    all-reduce) before the update."""
    world = mesh.world_size if mesh is not None else 1
    params = [p for p in model.parameters() if p.requires_grad]
    stats = bn_running_stats(model)
    panoptic = isinstance(model, PanopticFPN)

    def step(batch: Batch, generator: Optional[torch.Generator] = None):
        with span("u2s.forward"):
            model.train()
            optimizer.zero_grad(set_to_none=True)
            extra = {"sem_seg_gt": batch.sem_seg} if panoptic else {}
            losses = model(batch.images, batch.image_sizes, gt=batch.gt,
                           train=True, generator=generator, **extra)
            total = sum(losses.values())
        with span("u2s.backward"):
            total.backward()
            metrics = {k: v.detach() for k, v in losses.items()}
            metrics["total_loss"] = total.detach()
            if world > 1:
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                values = torch.stack([v.float() for v in metrics.values()])
                comm.all_reduce_mean_([p.grad for p in params] + stats + [values])
                metrics = dict(zip(metrics, values.unbind(0)))
        with span("u2s.optimizer"):
            optimizer.step()
        return metrics

    return step


def _gather_rows(tree: Any) -> Any:
    """``comm.all_gather_rows`` over every tensor of a dataclass tree."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return comm.all_gather_rows(tree)
    return dataclasses.replace(tree, **{f.name: _gather_rows(getattr(tree, f.name))
                                        for f in dataclasses.fields(tree)})


def make_eval_step(model: PanopticFPN, combine: bool = True
                   ) -> Callable[[torch.Tensor, torch.Tensor], PanopticOutput]:
    """-> ``step(images, image_sizes)``: the inference forward of ``model``
    (eval mode, no gradient; with the panoptic fusion where ``combine``) on
    a global batch, (B, H, W, 3) images and (B, 2) sizes. Each of the N
    processes of the default group runs its rows ``[rank * B/N, (rank + 1)
    * B/N)`` on the model's device, and the outputs are gathered over
    ``parallel.comm`` in rank order, so every process returns the whole
    batch's outputs, as the JAX step's ``out_specs=P("data")`` gives one
    global array. With one process it is the model's forward."""
    device = next(model.parameters()).device

    def step(images: torch.Tensor, image_sizes: torch.Tensor) -> PanopticOutput:
        world, rank = comm.get_world_size(), comm.get_rank()
        if images.shape[0] % world:
            raise ValueError(f"a batch of {images.shape[0]} does not split over {world} processes")
        n = images.shape[0] // world
        rows = slice(rank * n, (rank + 1) * n)
        model.eval()
        out = model(images[rows].to(device), image_sizes[rows].to(device),
                    train=False, combine=combine)
        return _gather_rows(out) if world > 1 else out

    return step
