"""kNN, k-means and USL representative selection on the tensors' device
(counterpart of ``u2seg_tpu/pseudo/kmeans.py``).

kNN and the Lloyd iterations are chunked matmuls, chunked only to bound
memory (a 2048-row kNN block at N = 131072 is 1 GB in f32). The cluster
sums are a one-hot matmul, which adds in a fixed order: two runs of one
generator seed give the same assignments (a float ``index_add_`` on the
card is atomic and would not). k-means++ draws its centroids from an
explicit ``torch.Generator`` on the data's device, with no host sync per
draw; its numbers differ from the JAX package's by construction.
Metrics: cosine and L2, as the reference.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def knn(feats: torch.Tensor, k: int, metric: str = "cosine",
        chunk: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of every row among all rows, itself excluded.

    Returns (dists (N, k), idx (N, k) int64), best first. cosine: the
    similarity; l2: the negative squared distance, so the top-k is the same
    for both."""
    n = feats.shape[0]
    base = _normalize(feats) if metric == "cosine" else feats
    sq = (base * base).sum(-1)
    dists = torch.empty((n, k), dtype=feats.dtype, device=feats.device)
    idxs = torch.empty((n, k), dtype=torch.int64, device=feats.device)
    cols = torch.arange(n, device=feats.device)
    for s in range(0, n, chunk):
        rows = base[s:s + chunk]
        if metric == "cosine":
            sim = rows @ base.T
        else:
            sim = -((rows * rows).sum(-1)[:, None] - 2 * rows @ base.T + sq[None, :])
        sim.masked_fill_(cols[s:s + chunk, None] == cols[None, :], float("-inf"))
        dists[s:s + chunk], idxs[s:s + chunk] = torch.topk(sim, k, dim=1)
    return dists, idxs


def _assign(x: torch.Tensor, c: torch.Tensor, metric: str) -> torch.Tensor:
    if metric == "cosine":
        return torch.argmax(x @ c.T, dim=1)
    d2 = (x * x).sum(1)[:, None] - 2 * x @ c.T + (c * c).sum(1)[None, :]
    return torch.argmin(d2, dim=1)


def assign(x: torch.Tensor, centroids: torch.Tensor, metric: str = "cosine",
           chunk: int = 8192) -> torch.Tensor:
    """The nearest centroid of each row of ``x`` (int64), ``chunk`` rows at a
    time; ties go to the lower centroid index."""
    return torch.cat([_assign(x[s:s + chunk], centroids, metric)
                      for s in range(0, x.shape[0], chunk)])


def lloyd(x: torch.Tensor, centroids: torch.Tensor, num_iters: int,
          metric: str = "cosine", chunk: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """``num_iters`` Lloyd steps from ``centroids`` over ``x`` (already
    normalised for cosine). Empty clusters keep their previous centroid;
    cosine centroids are renormalised. Returns (centroids, assignments)."""
    num_clusters = centroids.shape[0]
    c = centroids
    for _ in range(num_iters):
        sums = torch.zeros_like(c)
        counts = torch.zeros((num_clusters, 1), dtype=x.dtype, device=x.device)
        for s in range(0, x.shape[0], chunk):
            rows = x[s:s + chunk]
            onehot = torch.nn.functional.one_hot(
                _assign(rows, c, metric), num_clusters).to(x.dtype)    # (n, K)
            sums += onehot.T @ rows
            counts += onehot.sum(0)[:, None]
        c = torch.where(counts > 0, sums / torch.clamp(counts, min=1), c)
        if metric == "cosine":
            c = _normalize(c)
    return c, assign(x, c, metric, chunk)


def _kmeans_pp_init(x: torch.Tensor, num_clusters: int, metric: str,
                    generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding: the first centroid uniform, each next one drawn
    with probability proportional to max(d2, 1e-20) to its nearest chosen
    centroid (the JAX package draws ``categorical(log(max(d2, 1e-20)))``).

    A draw is ``argmax(p / q)`` with q ~ Exp(1), the algorithm of
    ``torch.multinomial`` for one sample, without its two validity checks
    that each read a value back to the host; every draw stays on ``x``'s
    device."""
    n, d = x.shape

    def dist2_to(c):
        if metric == "cosine":
            return torch.clamp(1.0 - x @ c, min=0.0)
        return ((x - c[None, :]) ** 2).sum(1)

    first = torch.randint(0, n, (1,), generator=generator, device=x.device)
    cents = torch.empty((num_clusters, d), dtype=x.dtype, device=x.device)
    cents[0] = x.index_select(0, first)[0]
    min_d2 = dist2_to(cents[0])
    q = torch.empty_like(min_d2)
    for i in range(1, num_clusters):
        q.exponential_(generator=generator)
        idx = torch.argmax(torch.clamp(min_d2, min=1e-20) / q, dim=0, keepdim=True)
        cents[i] = x.index_select(0, idx)[0]
        min_d2 = torch.minimum(min_d2, dist2_to(cents[i]))
    return cents


def kmeans(feats: torch.Tensor, num_clusters: int, num_iters: int = 100,
           metric: str = "cosine", chunk: int = 8192,
           generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm from a k-means++ seeding. Returns (centroids (K, D),
    assignments (N,) int64). cosine: spherical k-means (ref KMeans
    nn_utils.py:304-380); l2: standard. ``generator`` lies on ``feats``'
    device (a fresh one of seed 0 when None)."""
    if generator is None:
        generator = torch.Generator(device=feats.device).manual_seed(0)
    x = _normalize(feats) if metric == "cosine" else feats
    return lloyd(x, _kmeans_pp_init(x, num_clusters, metric, generator),
                 num_iters, metric, chunk)


def density_from_knn(knn_dists: torch.Tensor, metric: str = "cosine") -> torch.Tensor:
    """kNN-density score per sample: mean distance to the k nearest
    neighbours, smaller = denser; cosine similarity becomes 1 - sim."""
    if metric == "cosine":
        d = 1.0 - knn_dists
    else:
        d = torch.sqrt(torch.clamp(-knn_dists, min=0.0))
    return d.mean(dim=1)


def select_representatives(feats, assignments, density, num_clusters: int) -> np.ndarray:
    """The densest sample of each cluster, -1 for an empty one (the first,
    unregularised iteration of USL selection)."""
    assignments, density = np.asarray(assignments), np.asarray(density)
    reps = np.full(num_clusters, -1, np.int64)
    for c in range(num_clusters):
        members = np.nonzero(assignments == c)[0]
        if len(members):
            reps[c] = members[np.argmin(density[members])]
    return reps


def _selection_regularizer(feats: torch.Tensor, selected: torch.Tensor,
                           sel_src: torch.Tensor, labels: torch.Tensor,
                           alpha: float, horizon: int, exclude_same_cluster: bool,
                           chunk: int = 2048) -> torch.Tensor:
    """sum over the ``horizon`` nearest selected rows of 1 / d2^alpha, with
    the reference's exclusions (nn_utils_imagenet.py:154-210): a selected
    SLOT index equal to the sample's cluster label (the reference quirk,
    ``exclude_same_cluster``), else the sample itself (selected source index
    == row index) or a zero distance, pushed to 1e10 before the sum."""
    n = feats.shape[0]
    k = min(horizon, selected.shape[0])
    sel_sq = (selected * selected).sum(-1)
    reg = torch.empty(n, dtype=feats.dtype, device=feats.device)
    for s in range(0, n, chunk):
        rows = feats[s:s + chunk]
        d2 = (rows * rows).sum(-1)[:, None] - 2 * rows @ selected.T + sel_sq[None, :]
        negd, idx = torch.topk(-torch.clamp(d2, min=0.0), k, dim=1)
        dmin = -negd
        if exclude_same_cluster:
            drop = idx == labels[s:s + chunk, None]
        else:
            row_ids = torch.arange(s, s + rows.shape[0], device=feats.device)
            drop = (sel_src[idx] == row_ids[:, None]) | (dmin == 0.0)
        dmin = torch.where(drop, torch.full_like(dmin, 1e10), dmin)
        reg[s:s + chunk] = (1.0 / torch.pow(dmin, alpha)).sum(1)
    return reg


def select_representatives_regularized(
    feats: torch.Tensor,
    assignments: Sequence[int],
    neighbors_dist: Sequence[float],
    num_clusters: int,
    final_sample_num: Optional[int] = None,
    iters: int = 2,
    w: float = 0.05,
    momentum: float = 0.0,
    horizon_num: int = 32,
    alpha: float = 1.0,
    exclude_same_cluster: bool = True,
) -> np.ndarray:
    """Iterative kNN-regularised representative selection, the full USL
    protocol (ref ``nn_utils_imagenet.py:105-213``; U2Seg's
    ``ImageNet_usl_dino_0.2.yaml``: NITERS=2, W=0.05, MOMENTUM=0.0,
    HORIZON_NUM=32, ALPHA=1.0, EXCLUDE_SAME_CLUSTER=True).

    Each iteration picks, for each cluster in index order, the member of
    largest 1/neighbors_dist - w * regularizer (stopping at
    ``final_sample_num``); between iterations the regulariser is computed on
    ``feats``' device, and the greedy runs on the host in f64. Returns the
    indices of the last iteration (empty clusters skipped)."""
    assignments = np.asarray(assignments)
    neighbors_dist = np.asarray(neighbors_dist, np.float64)
    if final_sample_num is None:
        final_sample_num = num_clusters
    feats = feats.float()
    labels = torch.tensor(assignments, dtype=torch.int64, device=feats.device)
    regularizer = np.zeros(len(assignments), np.float64)
    order = np.argsort(assignments, kind="stable")
    bounds = np.searchsorted(assignments[order], np.arange(num_clusters + 1))
    members_by_cluster = [order[bounds[c]:bounds[c + 1]] for c in range(num_clusters)]
    selected: list = []
    for it in range(iters):
        selected = []
        for c in range(num_clusters):
            if len(selected) == final_sample_num:
                break
            members = members_by_cluster[c]
            if len(members) == 0:
                continue
            scores = 1.0 / neighbors_dist[members] - w * regularizer[members]
            selected.append(int(members[np.argmax(scores)]))
        if it < iters - 1 and selected:
            src = torch.as_tensor(selected, dtype=torch.int64, device=feats.device)
            new_reg = _selection_regularizer(
                feats, feats[src], src, labels, alpha, horizon_num,
                exclude_same_cluster).cpu().numpy().astype(np.float64)
            regularizer = regularizer * momentum + new_reg * (1 - momentum)
    return np.asarray(selected, np.int64)
