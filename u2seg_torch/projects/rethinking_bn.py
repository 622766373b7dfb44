"""Rethinking "Batch" in BatchNorm: the head-BN variants (counterpart of
``u2seg_tpu/projects/rethinking_bn.py``; detectron2's
``projects/Rethinking-BatchNorm``).

- ``BatchNormBatchStats``: BN that normalizes with the current batch's
  moments at inference too; it trains like the port's BN, with its names,
  so a BN checkpoint loads.
- ``shared_levels_norm``: one set of moments over all pyramid levels (the
  RetinaNet "shared training" head).
- ShuffleBN (``batch_shuffle`` / ``batch_unshuffle`` / ``shuffled_bn``): the
  global batch permuted across the processes of ``torch.distributed``
  before a per-process BN and restored after. The permutation comes from a
  ``torch.Generator`` that every process seeds alike (the JAX package
  derives it from one key on every replica). The rows travel by a summing
  all-reduce into one zeroed buffer, differentiable and exact, which every
  backend takes for CPU and CUDA tensors.
- The four recipes as Config transforms, and ``recompute_domain_stats``
  (PreciseBN's estimate on one domain's images).
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from u2seg_torch.ops.norms import BatchNorm2d
from u2seg_torch.parallel import comm


class BatchNormBatchStats(BatchNorm2d):
    """BN on NCHW tensors that normalizes with the CURRENT batch's moments
    in eval mode too: ``(x - mean) * rsqrt(var + eps) * weight + bias`` in
    f32 (the result stays f32, as in the JAX package), variance
    ``max(0, E[x^2] - E[x]^2)``. In training mode the running statistics
    move as the port's BN moves them; nothing reads them. ``sync`` averages
    the moments over the process group (SyncBNBatchStats)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        mean2 = (xf * xf).mean(dim=(0, 2, 3))
        world = comm.get_world_size() if self.sync else 1
        if world > 1:
            from torch.distributed.nn.functional import all_reduce

            mean, mean2 = (all_reduce(torch.stack([mean, mean2])) / world).unbind(0)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        if self.training:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return ((xf - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
                * self.weight.view(shape) + self.bias.view(shape))


def shared_levels_norm(norm_mod: Optional[nn.Module],
                       features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Normalize ALL levels with one call of ``norm_mod``: each (B, C, H_l,
    W_l) level flattened spatially, concatenated, normalized once, split."""
    if norm_mod is None:
        return list(features)
    b, c = features[0].shape[:2]
    sizes = [f.shape[2] * f.shape[3] for f in features]
    flat = torch.cat([f.reshape(b, c, -1, 1) for f in features], dim=2)
    flat = norm_mod(flat)
    return [part.reshape(b, c, *f.shape[2:])
            for part, f in zip(flat.split(sizes, dim=2), features)]


def _gather_rows(x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """Every process's (b, ...) rows in rank order, (world * b, ...), with
    gradients back to each process's own rows."""
    world, rank = comm.get_world_size(), comm.get_rank()
    b = x.shape[0]
    if world == 1:
        return x, rank, b
    from torch.distributed.nn.functional import all_reduce

    buf = x.new_zeros((world * b,) + tuple(x.shape[1:]))
    buf = torch.cat([buf[:rank * b], x, buf[(rank + 1) * b:]])
    return all_reduce(buf), rank, b


def batch_shuffle(x: torch.Tensor, generator: torch.Generator):
    """Shuffle the leading dim across all processes -> (this process's rows
    of the shuffled global batch, the permutation). ``generator`` (a CPU
    generator) must be seeded alike on every process."""
    all_x, rank, b = _gather_rows(x)
    perm = torch.randperm(all_x.shape[0], generator=generator).to(x.device)
    return all_x[perm[rank * b:(rank + 1) * b]], perm


def batch_unshuffle(y: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The inverse of ``batch_shuffle``: each process's own rows back."""
    all_y, rank, b = _gather_rows(y)
    inv = torch.argsort(perm)
    return all_y[inv[rank * b:(rank + 1) * b]]


def shuffled_bn(norm_mod: nn.Module, x: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """A per-process BN on a cross-process shuffled batch in training mode;
    the plain norm (running statistics) in eval mode."""
    if not norm_mod.training:
        return norm_mod(x)
    x, perm = batch_shuffle(x, generator)
    return batch_unshuffle(norm_mod(x), perm)


# ---------------------------------------------------------------------------
# Recipes: the reference's lazy configs as Config transforms
# ---------------------------------------------------------------------------

def mask_rcnn_bn_head(cfg=None):
    """mask_rcnn_BNhead: the 4conv1fc box head, BN in the box and mask heads."""
    from u2seg_torch.config import Config

    cfg = cfg or Config()
    cfg.model.roi_heads.box_head.num_conv = 4
    cfg.model.roi_heads.box_head.num_fc = 1
    cfg.model.roi_heads.box_head.norm = "BN"
    cfg.model.roi_heads.mask_head.norm = "BN"
    return cfg


def mask_rcnn_syncbn_head(cfg=None):
    """mask_rcnn_SyncBNhead."""
    cfg = mask_rcnn_bn_head(cfg)
    cfg.model.roi_heads.box_head.norm = "SyncBN"
    cfg.model.roi_heads.mask_head.norm = "SyncBN"
    return cfg


def mask_rcnn_bn_head_batch_stats(cfg=None):
    """mask_rcnn_BNhead_batch_stats: trained as ``mask_rcnn_bn_head``,
    evaluated with batch statistics."""
    cfg = mask_rcnn_bn_head(cfg)
    cfg.model.roi_heads.box_head.norm = "BNBatchStats"
    cfg.model.roi_heads.mask_head.norm = "BNBatchStats"
    return cfg


def retinanet_syncbn_head(cfg=None, shared_training: bool = False):
    """retinanet_SyncBNhead (+ SharedTraining): SyncBN in the RetinaNet
    towers; ``shared_training`` normalizes all levels with one set of
    moments. Takes and returns a ``RetinaNetConfig``."""
    from u2seg_torch.config import RetinaNetConfig

    cfg = cfg or RetinaNetConfig()
    cfg.head_norm = "SyncBN"
    cfg.head_shared_bn = shared_training
    return cfg


def recompute_domain_stats(model: nn.Module, forward: Callable[[object], object],
                           batches: Iterable, num_iters: int = 100) -> int:
    """Before evaluating on a domain, re-estimate every BN's running
    statistics from that domain's batches (``engine.precise_bn``'s true
    average). Returns the number of batches used."""
    from u2seg_torch.engine.precise_bn import estimate_bn_stats

    return estimate_bn_stats(model, forward, batches, num_iters=num_iters)
