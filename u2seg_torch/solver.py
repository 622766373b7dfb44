"""Optimizer and LR schedule construction (counterpart of
``u2seg_tpu/solver.py``, which chains optax transforms).

``build_optimizer`` returns, for ``solver.optimizer`` "SGD", one
``torch.optim.SGD`` subclass whose ``step`` applies, in the JAX package's
order: gradient clipping, L2 weight decay added to the gradient (per
parameter group), momentum, then the scheduled learning rate (times
``bias_lr_factor`` for the bias group). For "AdamW" (which the JAX package
does not have) it returns a ``torch.optim.AdamW`` subclass on the same
groups and schedule: detectron2's AdamW with decoupled weight decay, fused
on the card and foreach elsewhere. Both take ViT's layer-wise lr decay
(``vit_lr_factor``) and names that take no weight decay
(``no_weight_decay``) when the configuration asks; by default every
parameter of a group shares one factor and one decay.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
from torch import nn

from u2seg_torch.config import SolverConfig
from u2seg_torch.ops.norms import BatchNorm2d, GroupNorm
from u2seg_torch.utils.spans import span


def multistep_schedule(base_lr: float, steps, gamma: float, warmup_iters: int,
                       warmup_factor: float,
                       warmup_method: str = "linear") -> Callable[[int], float]:
    """WarmupMultiStepLR: warmup, then decay by ``gamma`` at each milestone."""
    steps = tuple(steps)
    if warmup_method not in ("linear", "constant"):
        raise ValueError(warmup_method)

    def schedule(count: int) -> float:
        if warmup_method == "linear":
            alpha = min(max(count / max(warmup_iters, 1), 0.0), 1.0)
            warm = warmup_factor * (1 - alpha) + alpha
        else:
            warm = warmup_factor if count < warmup_iters else 1.0
        decay = 1.0
        for s in steps:
            decay *= gamma if count >= s else 1.0
        return base_lr * warm * decay

    return schedule


def cosine_schedule(base_lr: float, max_iter: int, warmup_iters: int,
                    warmup_factor: float,
                    end_value: float = 0.0) -> Callable[[int], float]:
    """WarmupCosineLR."""

    def schedule(count: int) -> float:
        alpha = min(max(count / max(warmup_iters, 1), 0.0), 1.0)
        warm = warmup_factor * (1 - alpha) + alpha
        t = min(max(count / max_iter, 0.0), 1.0)
        cos = end_value + (1 - end_value) * 0.5 * (1 + math.cos(math.pi * t))
        return base_lr * warm * cos

    return schedule


def build_lr_schedule(cfg: SolverConfig) -> Callable[[int], float]:
    """count of updates done so far -> learning rate of the next update."""
    if cfg.scheduler == "WarmupMultiStepLR":
        return multistep_schedule(cfg.base_lr, cfg.steps, cfg.gamma,
                                  cfg.warmup_iters, cfg.warmup_factor,
                                  cfg.warmup_method)
    if cfg.scheduler == "WarmupCosineLR":
        return cosine_schedule(cfg.base_lr, cfg.max_iter, cfg.warmup_iters,
                               cfg.warmup_factor)
    raise ValueError(f"Unknown scheduler {cfg.scheduler}")


def param_group_labels(model: nn.Module) -> Dict[str, str]:
    """Parameter name -> "norm" / "bias" / "regular": both parameters of a
    norm layer (BatchNorm, GroupNorm, LayerNorm) are "norm"; any other
    parameter named ``bias`` is "bias"."""
    labels = {}
    for mod_name, mod in model.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{p_name}" if mod_name else p_name
            if isinstance(mod, (BatchNorm2d, GroupNorm, nn.LayerNorm)):
                labels[full] = "norm"
            else:
                labels[full] = "bias" if p_name == "bias" else "regular"
    return labels


class ScheduledSGD(torch.optim.SGD):
    """SGD with momentum whose ``step`` first clips the gradients, then sets
    each group's learning rate from the schedule. The count of updates lives
    in the parameter groups (``group["count"]``), so ``state_dict`` keeps it.
    """

    def __init__(self, groups: List[dict], schedule: Callable[[int], float],
                 momentum: float, nesterov: bool, clip_type: str = "",
                 clip_value: float = 0.0):
        self.schedule = schedule
        self.clip_type = clip_type
        self.clip_value = clip_value
        for g in groups:
            g.setdefault("count", 0)
            g["lr"] = schedule(g["count"]) * g["lr_factor"]
        super().__init__(groups, lr=schedule(0), momentum=momentum,
                         nesterov=nesterov)

    def clip_gradients(self) -> None:
        """"norm": scale every gradient by ``clip / max(global norm, clip)``
        (no epsilon); "value": clamp each element to [-clip, clip]."""
        grads = [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        if not grads or not self.clip_type:
            return
        if self.clip_type == "norm":
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            scale = self.clip_value / torch.clamp(norm, min=self.clip_value)
            torch._foreach_mul_(grads, scale)
        else:
            for g in grads:
                g.clamp_(-self.clip_value, self.clip_value)

    @torch.no_grad()
    def step(self, closure=None):
        with span("u2s.optimizer.clip"):
            self.clip_gradients()
        for g in self.param_groups:
            g["lr"] = self.schedule(g["count"]) * g["lr_factor"]
            g["count"] += 1
        return super().step(closure)


class ScheduledAdamW(torch.optim.AdamW):
    """AdamW (decoupled weight decay, betas (0.9, 0.999), eps 1e-8) whose
    ``step`` clips the gradients (when configured) and sets each group's
    learning rate from the schedule, as ``ScheduledSGD`` does; one fused
    update on the card, a foreach one elsewhere."""

    clip_gradients = ScheduledSGD.clip_gradients

    def __init__(self, groups: List[dict], schedule: Callable[[int], float],
                 clip_type: str = "", clip_value: float = 0.0):
        self.schedule = schedule
        self.clip_type = clip_type
        self.clip_value = clip_value
        for g in groups:
            g.setdefault("count", 0)
            g["lr"] = schedule(g["count"]) * g["lr_factor"]
        on_card = all(p.is_cuda for g in groups for p in g["params"])
        super().__init__(groups, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                         **({"fused": True} if on_card else {"foreach": True}))

    @torch.no_grad()
    def step(self, closure=None):
        with span("u2s.optimizer.clip"):
            self.clip_gradients()
        for g in self.param_groups:
            g["lr"] = self.schedule(g["count"]) * g["lr_factor"]
            g["count"] += 1
        return super().step(closure)


def vit_lr_factor(name: str, rate: float, layers: int) -> float:
    """detectron2's ``get_vit_lr_decay_rate``: ``rate ** (layers + 1 -
    layer_id)``, ``layer_id`` 0 for the backbone's ``pos_embed`` and
    ``patch_embed``, i + 1 for its ``blocks.i``, layers + 1 elsewhere."""
    layer_id = layers + 1
    if name.startswith("backbone"):
        if ".pos_embed" in name or ".patch_embed" in name:
            layer_id = 0
        elif ".blocks." in name and ".residual." not in name:
            layer_id = int(name[name.find(".blocks."):].split(".")[2]) + 1
    return rate ** (layers + 1 - layer_id)


def build_optimizer(cfg: SolverConfig, model: nn.Module):
    """``solver.optimizer`` over the parameters of ``model`` with per-group
    weight decay, gradient clipping and the LR schedule: norm-layer
    parameters decay by ``weight_decay_norm``, biases by ``weight_decay_bias``
    (None: the base value) with their LR scaled by ``bias_lr_factor``, the
    parameters named in ``no_weight_decay`` by nothing; with
    ``vit_lr_decay_rate`` below 1 each parameter's LR is also scaled by
    ``vit_lr_factor`` over the depth of the model's ViT trunk
    (``backbone.net.blocks``). Groups follow the labels' order, then each
    label's first appearance of a (decay, factor) pair."""
    wd = cfg.weight_decay
    decay = {"regular": wd,
             "norm": wd if cfg.weight_decay_norm is None else cfg.weight_decay_norm,
             "bias": wd if cfg.weight_decay_bias is None else cfg.weight_decay_bias}
    labels = param_group_labels(model)
    params = dict(model.named_parameters())
    groups: Dict[tuple, dict] = {}
    layers = len(model.backbone.net.blocks) if cfg.vit_lr_decay_rate != 1.0 else 0
    for name in ("regular", "norm", "bias"):
        for k, lab in labels.items():
            if lab != name or k not in params:
                continue
            w = 0.0 if k.rsplit(".", 1)[-1] in cfg.no_weight_decay else decay[name]
            f = cfg.bias_lr_factor if name == "bias" else 1.0
            if cfg.vit_lr_decay_rate != 1.0:
                f *= vit_lr_factor(k, cfg.vit_lr_decay_rate, layers)
            groups.setdefault((name, w, f), {
                "params": [], "name": name, "weight_decay": w,
                "lr_factor": f})["params"].append(params[k])
    groups = list(groups.values())
    clip_type = cfg.clip_type if cfg.clip_gradients else ""
    if cfg.optimizer == "AdamW":
        return ScheduledAdamW(groups, build_lr_schedule(cfg), clip_type,
                              cfg.clip_value)
    if cfg.optimizer != "SGD":
        raise ValueError(f"unknown solver.optimizer {cfg.optimizer!r}")
    return ScheduledSGD(groups, build_lr_schedule(cfg), cfg.momentum,
                        cfg.nesterov, clip_type, cfg.clip_value)
