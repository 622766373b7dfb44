"""detectron2's AdamW for ViTDet, written out: parameter groups by
``get_default_optimizer_params`` (norm parameters, of every LayerNorm,
decay by ``weight_decay_norm``; the names of ``no_weight_decay`` by
nothing; biases by ``weight_decay_bias``, None: the base value) with each
parameter's lr scaled by ``get_vit_lr_decay_rate``, and the warm-up and
step schedule of ``portbench.refmodel.solver``, ``num_layers`` the depth
of the model's trunk. The update is Adam's (betas 0.9, 0.999) with bias
corrections and decoupled weight decay, element by element in f32 on
each leaf; no clipping (the recipe has none)."""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
from torch import nn

from portbench.refmodel.solver import build_lr_schedule


def lr_decay(name: str, rate: float, layers: int) -> float:
    """detectron2's ``get_vit_lr_decay_rate(name, rate, layers)``."""
    layer_id = layers + 1
    if name.startswith("backbone"):
        if ".pos_embed" in name or ".patch_embed" in name:
            layer_id = 0
        elif ".blocks." in name and ".residual." not in name:
            layer_id = int(name[name.find(".blocks."):].split(".")[2]) + 1
    return rate ** (layers + 1 - layer_id)


class AdamW(torch.optim.Optimizer):
    """``p <- p (1 - lr wd)``, then ``p <- p - lr / (1 - b1^t) * m / (sqrt(v)
    / sqrt(1 - b2^t) + eps)`` with ``m``, ``v`` the moving moments
    (``exp_avg``, ``exp_avg_sq``); each group's lr is the schedule at its
    count of updates times its ``lr_factor``."""

    betas = (0.9, 0.999)

    def __init__(self, groups: List[dict], schedule: Callable[[int], float],
                 eps: float = 1e-8):
        self.schedule, self.eps = schedule, eps
        for g in groups:
            g["count"] = 0
        super().__init__(groups, {"lr": 0.0})

    @torch.no_grad()
    def step(self, closure=None):
        b1, b2 = self.betas
        for g in self.param_groups:
            lr = self.schedule(g["count"]) * g["lr_factor"]
            g["count"] += 1
            for p in g["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                t = st["step"]
                p.mul_(1 - lr * g["weight_decay"])
                st["exp_avg"].mul_(b1).add_(p.grad, alpha=1 - b1)
                st["exp_avg_sq"].mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
                denom = (st["exp_avg_sq"].sqrt() / math.sqrt(1 - b2 ** t)).add_(self.eps)
                p.addcdiv_(st["exp_avg"], denom, value=-lr / (1 - b1 ** t))


def build_optimizer(cfg, model: nn.Module) -> AdamW:
    if cfg.optimizer != "AdamW":
        raise ValueError("the ViTDet reference trains with AdamW")
    norms = {f"{m_name}.{p_name}" if m_name else p_name
             for m_name, m in model.named_modules() if isinstance(m, nn.LayerNorm)
             for p_name, _ in m.named_parameters(recurse=False)}
    wd = cfg.weight_decay
    layers = len(model.backbone.net.blocks)
    groups: Dict[tuple, dict] = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        if name.rsplit(".", 1)[-1] in cfg.no_weight_decay:
            decay = 0.0
        elif name in norms:
            decay = wd if cfg.weight_decay_norm is None else cfg.weight_decay_norm
        elif name.endswith(".bias"):
            decay = wd if cfg.weight_decay_bias is None else cfg.weight_decay_bias
        else:
            decay = wd
        factor = lr_decay(name, cfg.vit_lr_decay_rate, layers)
        if name.endswith(".bias") and name not in norms:
            factor *= cfg.bias_lr_factor
        groups.setdefault((decay, factor), {"params": [], "weight_decay": decay,
                                            "lr_factor": factor})["params"].append(p)
    return AdamW(list(groups.values()), build_lr_schedule(cfg))
