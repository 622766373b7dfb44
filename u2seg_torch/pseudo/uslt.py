"""USL-T: learned multi-head clustering over frozen features (counterpart of
``u2seg_tpu/pseudo/uslt.py``).

Several linear cluster heads over a frozen embedding, trained with a local
neighbour-consistency loss on sharpened pseudo-labels and a global
entropy-balancing loss (ref ``uslt_utils.py``: ClusteringModel :266, local
loss :18, global loss :68). ``torch.optim.Adam`` makes optax's Adam update
(eps outside the square root, both moments bias-corrected).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn


class ClusteringHeads(nn.Module):
    """``num_heads`` independent linear cluster heads ``head{i}`` (ref
    uslt_utils.py:266-324)."""

    def __init__(self, in_dim: int, num_clusters: int, num_heads: int = 3):
        super().__init__()
        self.num_heads = num_heads
        for i in range(num_heads):
            setattr(self, f"head{i}", nn.Linear(in_dim, num_clusters))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's Dense init from ``generator``: lecun normal (truncated at 2
        std) weights, zero biases."""
        with torch.no_grad():
            for i in range(self.num_heads):
                head = getattr(self, f"head{i}")
                std = math.sqrt(1.0 / head.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(head.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                head.bias.zero_()

    def forward(self, feats: torch.Tensor) -> List[torch.Tensor]:
        return [getattr(self, f"head{i}")(feats) for i in range(self.num_heads)]


def sharpen(p: torch.Tensor, temperature: float = 0.5) -> torch.Tensor:
    """Temperature sharpening of soft assignments (ref :18-40)."""
    q = p ** (1.0 / temperature)
    return q / q.sum(-1, keepdim=True)


def local_consistency_loss(logits_anchor: torch.Tensor, logits_neighbor: torch.Tensor,
                           temperature: float = 0.5,
                           confidence_threshold: float = 0.0) -> torch.Tensor:
    """Neighbour agreement: CE(sharpened, detached anchor || neighbour)
    (ref uslt_utils.py:18-66)."""
    p_anchor = torch.softmax(logits_anchor, -1)
    target = sharpen(p_anchor.detach(), temperature)
    ce = -(target * torch.log_softmax(logits_neighbor, -1)).sum(-1)
    if confidence_threshold > 0:
        w = (p_anchor.max(-1).values > confidence_threshold).to(ce.dtype)
        return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)
    return ce.mean()


def global_entropy_loss(logits: torch.Tensor) -> torch.Tensor:
    """-H(mean assignment): minimising it keeps every cluster used (ref
    uslt_utils.py:68-100)."""
    mean_p = torch.clamp(torch.softmax(logits, -1).mean(0), 1e-8, 1.0)
    return (mean_p * torch.log(mean_p)).sum()


def uslt_loss(head_logits_anchor: Sequence[torch.Tensor],
              head_logits_neighbor: Sequence[torch.Tensor],
              global_weight: float = 2.0,
              temperature: float = 0.5) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    n = len(head_logits_anchor)
    local = sum(local_consistency_loss(a, b, temperature)
                for a, b in zip(head_logits_anchor, head_logits_neighbor)) / n
    glob = sum(global_entropy_loss(a) for a in head_logits_anchor) / n
    return local + global_weight * glob, {"loss_local": local, "loss_global": glob}


def make_uslt_train_step(model: ClusteringHeads, optimizer: torch.optim.Optimizer
                         ) -> Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """One update of ``model`` by ``optimizer`` on a batch of anchor and
    neighbour features; returns the detached losses."""
    def step(feats_anchor: torch.Tensor, feats_neighbor: torch.Tensor):
        optimizer.zero_grad(set_to_none=True)
        total, metrics = uslt_loss(model(feats_anchor), model(feats_neighbor))
        total.backward()
        optimizer.step()
        metrics["loss"] = total
        return {k: v.detach() for k, v in metrics.items()}

    return step


def train_uslt(feats: torch.Tensor, neighbor_idx: torch.Tensor, num_clusters: int,
               num_heads: int = 3, steps: int = 1000, batch_size: int = 1024,
               lr: float = 1e-3, generator: Optional[torch.Generator] = None):
    """Train the clustering heads on fixed features and their kNN graph, on
    ``feats``' device; ``generator`` (on that device; seed 0 when None)
    draws the initial weights and the batches. Returns (model, assignments
    (N,) of the head with the lowest mean entropy, the heads' entropies)."""
    dev = feats.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = ClusteringHeads(feats.shape[1], num_clusters, num_heads).to(dev)
    model.reset_parameters(generator)
    step = make_uslt_train_step(model, torch.optim.Adam(model.parameters(), lr=lr))
    neighbor_idx = neighbor_idx.to(dev)
    n, k = feats.shape[0], neighbor_idx.shape[1]
    for _ in range(steps):
        idx = torch.randint(0, n, (min(batch_size, n),), generator=generator, device=dev)
        choice = torch.randint(0, k, idx.shape, generator=generator, device=dev)
        step(feats[idx], feats[neighbor_idx[idx, choice]])
    with torch.no_grad():
        logits = model(feats)
    entropies = []
    for l in logits:
        p = torch.softmax(l, -1)
        entropies.append(float((-(p * torch.log(torch.clamp(p, 1e-8, 1))).sum(-1)).mean()))
    best = min(range(num_heads), key=entropies.__getitem__)
    return model, torch.argmax(logits[best], dim=-1), entropies
