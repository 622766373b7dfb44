"""DensePose CSE: continuous surface embeddings (counterpart of
``u2seg_tpu/projects/densepose_cse.py``; the CSE half of detectron2's
``projects/DensePose``).

Per-mesh vertex embedders (a free table, or fixed / trainable features
times a projection; L2-normalised), the embedding predictor (deconv 2x +
bilinear 2x heads: a D-channel pixel embedding and a coarse segmentation
per ROI), the embedding loss (CE over ``-||e_pix - e_vertex||^2 / sigma``
at annotated points, per mesh), the pixel -> vertex -> pixel cycle loss,
and nearest-vertex inference.

NCHW maps ``(N, D, S, S)``. A ``vertex_feature`` embedder's fixed features
are a buffer (flax keeps them in its ``constants`` collection). The cycle
loss picks up to ``num_pixels`` foreground pixels per ROI by masked Gumbel
top-k: ``pix2shape_picks`` draws them from a ``torch.Generator``, and the
loss takes them as an argument.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from u2seg_torch.ops.nms import topk_stable
from u2seg_torch.projects.densepose import (DensePoseConfig, DensePoseV1ConvXHead, chart_deconv,
                                            chart_point_sample, deconv_upscaled, pool_fpn_rois)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """One mesh's embedder."""
    name: str
    num_vertices: int
    embedder_type: str = "vertex_direct"   # or "vertex_feature"
    feature_dim: int = 0                   # for vertex_feature
    features_trainable: bool = False


@dataclasses.dataclass(frozen=True)
class CSEConfig:
    """ROI_DENSEPOSE_HEAD.CSE defaults (detectron2 DensePose's config)."""
    embed_size: int = 16
    embedding_dist_gauss_sigma: float = 0.01
    embed_loss_weight: float = 0.6
    segm_weight: float = 2.0
    num_coarse_segm_channels: int = 2
    deconv_kernel: int = 4
    up_scale: int = 2
    meshes: Tuple[MeshSpec, ...] = (MeshSpec("smpl_27554", 27554),)
    pix2shape_enabled: bool = False
    pix2shape_weight: float = 1e-4
    pix2shape_num_pixels: int = 100
    pix2shape_temp_pix2vertex: float = 0.05
    pix2shape_temp_vertex2pix: float = 0.05
    pix2shape_norm_p: int = 2


def normalize_embeddings(e: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """L2-normalise along the last axis: ``e / max(|e|, eps)``. The floor is
    taken under the square root (the same values): the gradient of an
    all-zero row is then finite, where ``sqrt`` at 0 would make it NaN."""
    norm = torch.sqrt(torch.clamp(torch.sum(e * e, dim=-1, keepdim=True), min=eps * eps))
    return e / norm


def squared_euclidean_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, D) x (K, D) -> (..., M, K) squared distances, in the matmul
    form ``|a|^2 + |b|^2 - 2 a.b``."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1)
    return a2 + b2 - 2.0 * (a @ b.transpose(-1, -2))


class VertexDirectEmbedder(nn.Module):
    """A free (N, D) ``embeddings`` table, normalised."""

    def __init__(self, num_vertices: int, embed_dim: int):
        super().__init__()
        self.embeddings = nn.Parameter(torch.zeros(num_vertices, embed_dim))

    def forward(self) -> torch.Tensor:
        return normalize_embeddings(self.embeddings)


class VertexFeatureEmbedder(nn.Module):
    """normalize(features @ embed_matrix): (N, K) features, a buffer unless
    trainable, and a (K, D) projection."""

    def __init__(self, num_vertices: int, feature_dim: int, embed_dim: int,
                 train_features: bool = False):
        super().__init__()
        feats = torch.zeros(num_vertices, feature_dim)
        if train_features:
            self.features = nn.Parameter(feats)
        else:
            self.register_buffer("features", feats)
        self.embed_matrix = nn.Parameter(torch.zeros(feature_dim, embed_dim))

    def forward(self) -> torch.Tensor:
        return normalize_embeddings(self.features @ self.embed_matrix)


class Embedder(nn.Module):
    """Mesh name -> vertex embeddings: one ``embedder_{name}`` per mesh."""

    def __init__(self, cfg: CSEConfig):
        super().__init__()
        self.cfg = cfg
        for spec in cfg.meshes:
            if spec.embedder_type == "vertex_direct":
                mod = VertexDirectEmbedder(spec.num_vertices, cfg.embed_size)
            elif spec.embedder_type == "vertex_feature":
                mod = VertexFeatureEmbedder(spec.num_vertices, spec.feature_dim,
                                            cfg.embed_size, spec.features_trainable)
            else:
                raise ValueError(spec.embedder_type)
            self.add_module(f"embedder_{spec.name}", mod)

    def mesh_names(self) -> List[str]:
        return [s.name for s in self.cfg.meshes]

    def forward(self, mesh_name: Optional[str] = None):
        """One mesh's embeddings, or a dict of every mesh's."""
        if mesh_name is None:
            return {s.name: getattr(self, f"embedder_{s.name}")() for s in self.cfg.meshes}
        return getattr(self, f"embedder_{mesh_name}")()


class DensePoseEmbeddingPredictor(nn.Module):
    """``embed_lowres`` and ``coarse_segm_lowres`` deconvs, each then
    bilinearly upscaled ``up_scale`` x: (N, C, S, S) -> {embedding (N, D,
    4S, 4S), coarse_segm (N, C_segm, 4S, 4S)}."""

    def __init__(self, cfg: CSEConfig, in_channels: int):
        super().__init__()
        self.cfg = cfg
        self.embed_lowres = chart_deconv(in_channels, cfg.embed_size, cfg.deconv_kernel)
        self.coarse_segm_lowres = chart_deconv(in_channels, cfg.num_coarse_segm_channels,
                                          cfg.deconv_kernel)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        s = self.cfg.up_scale
        return {"embedding": deconv_upscaled(self.embed_lowres, x, s),
                "coarse_segm": deconv_upscaled(self.coarse_segm_lowres, x, s)}


@dataclasses.dataclass
class CsePoints:
    """Annotated vertices per ROI, (N, P) arrays masked by ``valid``; x / y
    in the proposal box's [0, 1] frame."""
    x: torch.Tensor
    y: torch.Tensor
    vertex_ids: torch.Tensor     # (N, P) int
    mesh_ids: torch.Tensor       # (N, P) int, index into CSEConfig.meshes
    valid: torch.Tensor          # (N, P) bool


def embedding_loss(embedding_maps: torch.Tensor, points: CsePoints,
                   mesh_embeddings: Sequence[torch.Tensor], roi_valid: torch.Tensor,
                   gauss_sigma: float = 0.01) -> Dict[int, torch.Tensor]:
    """Per mesh: CE over the vertex scores ``-||e_pix - e_vert||^2 / sigma``
    at the mesh's annotated points, the pixel embedding bilinearly sampled
    and normalised; averaged over those points."""
    n, p = points.valid.shape
    d = embedding_maps.shape[1]
    coords = torch.stack([points.x, points.y], -1)
    sampled = normalize_embeddings(chart_point_sample(embedding_maps, coords)).reshape(n * p, d)
    vids = points.vertex_ids.reshape(n * p).long()
    mids = points.mesh_ids.reshape(n * p)
    ok = (points.valid & roi_valid[:, None]).reshape(n * p)
    losses = {}
    for m, mesh_e in enumerate(mesh_embeddings):
        sel = ok & (mids == m)
        scores = -squared_euclidean_distance_matrix(sampled, mesh_e) / gauss_sigma
        logp = torch.log_softmax(scores, dim=-1)
        vid = torch.clamp(vids, 0, mesh_e.shape[0] - 1)
        ce = -torch.gather(logp, 1, vid[:, None])[:, 0]
        losses[m] = (torch.sum(torch.where(sel, ce, torch.zeros_like(ce)))
                     / torch.clamp(sel.sum(), min=1))
    return losses


def pix2shape_picks(fg_masks: torch.Tensor, num_pixels: int,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Up to ``num_pixels`` foreground pixels per ROI of (N, S, S) masks, a
    uniform subset by masked Gumbel top-k -> flat pixel indices (N, M)."""
    flat = fg_masks.reshape(fg_masks.shape[0], -1)
    u = torch.rand(flat.shape, generator=generator, device=flat.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
    score = torch.where(flat, gumbel, torch.full_like(gumbel, -float("inf")))
    return topk_stable(score, num_pixels)[1]


def pix_to_shape_cycle_loss(embedding_maps: torch.Tensor, fg_masks: torch.Tensor,
                            roi_valid: torch.Tensor, mesh_embeddings: Sequence[torch.Tensor],
                            picks: torch.Tensor, temp_p2v: float = 0.05,
                            temp_v2p: float = 0.05, norm_p: int = 2) -> torch.Tensor:
    """Pixel -> vertex -> pixel softmax cycle at the picked pixels (N, M),
    penalised by their squared pixel distances, averaged over the meshes
    and the valid ROIs."""
    n, d, s, _ = embedding_maps.shape
    flat_e = embedding_maps.permute(0, 2, 3, 1).reshape(n, s * s, d)
    picked_ok = torch.gather(fg_masks.reshape(n, s * s), 1, picks)
    pe = normalize_embeddings(torch.gather(flat_e, 1, picks[..., None].expand(-1, -1, d)))
    ok = picked_ok & roi_valid[:, None]
    rc = torch.stack([torch.div(picks, s, rounding_mode="floor"), picks % s], -1).float()
    pd = (torch.sum(rc * rc, -1)[..., None] + torch.sum(rc * rc, -1)[:, None, :]
          - 2.0 * (rc @ rc.transpose(1, 2)))                         # (N, M, M)
    pair = ok[:, :, None] & ok[:, None, :]
    total = torch.zeros(n, device=embedding_maps.device)
    neg = torch.tensor(-1e9, device=embedding_maps.device)
    for mesh_e in mesh_embeddings:
        sim = pe @ mesh_e.T                                          # (N, M, K)
        c_pv = torch.softmax(torch.where(ok[:, :, None], sim / temp_p2v, neg), dim=-1)
        c_vp = torch.softmax(torch.where(ok[:, None, :], sim.transpose(1, 2) / temp_v2p, neg),
                             dim=-1)
        c_cycle = (c_pv @ c_vp) * pair
        total = total + torch.pow(torch.sum(torch.abs(pd * c_cycle) ** norm_p, dim=(1, 2))
                                  + 1e-12, 1.0 / norm_p)
    per = torch.where(roi_valid & ok.any(-1), total / len(mesh_embeddings),
                      torch.zeros_like(total))
    return per.sum() / torch.clamp(roi_valid.sum(), min=1)


def _nearest_resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` of (N, S, S) to (N, size, size):
    source index floor((i + 0.5) * S / size) in f32."""
    idx = torch.floor((torch.arange(size, dtype=torch.float32, device=x.device) + 0.5)
                      * x.shape[1] / size).long()
    return x[:, idx][:, :, idx]


def densepose_cse_losses(predictor_out: Dict[str, torch.Tensor], points: CsePoints,
                         coarse_segm_gt: torch.Tensor, roi_valid: torch.Tensor,
                         mesh_embeddings: Sequence[torch.Tensor], cfg: CSEConfig,
                         mesh_names: Optional[Sequence[str]] = None,
                         picks: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """The CSE loss dict: ``loss_densepose_S`` (coarse CE), one
    ``loss_densepose_E{mesh}`` per mesh, and ``loss_pix2shape`` when enabled
    (at ``picks``, or at pixels drawn from ``generator``)."""
    names = list(mesh_names or [s.name for s in cfg.meshes])
    segm = predictor_out["coarse_segm"]
    logp = torch.log_softmax(segm, dim=1)
    gt = torch.clamp(coarse_segm_gt.long(), 0, segm.shape[1] - 1)
    ce = -torch.gather(logp, 1, gt[:, None])[:, 0]
    w = roi_valid[:, None, None].expand_as(ce)
    loss_s = torch.sum(torch.where(w, ce, torch.zeros_like(ce))) / torch.clamp(
        w.sum().float(), min=1.0)
    emb = embedding_loss(predictor_out["embedding"], points, mesh_embeddings, roi_valid,
                         gauss_sigma=cfg.embedding_dist_gauss_sigma)
    out = {"loss_densepose_S": cfg.segm_weight * loss_s}
    for m, name in enumerate(names):
        out[f"loss_densepose_E{name}"] = cfg.embed_loss_weight * emb[m]
    if cfg.pix2shape_enabled:
        fg = coarse_segm_gt > 0
        s_out = predictor_out["embedding"].shape[2]
        if fg.shape[1] != s_out:
            fg = _nearest_resize(fg, s_out)
        if picks is None:
            picks = pix2shape_picks(fg, cfg.pix2shape_num_pixels, generator)
        out["loss_pix2shape"] = cfg.pix2shape_weight * pix_to_shape_cycle_loss(
            predictor_out["embedding"], fg, roi_valid, mesh_embeddings, picks,
            temp_p2v=cfg.pix2shape_temp_pix2vertex, temp_v2p=cfg.pix2shape_temp_vertex2pix,
            norm_p=cfg.pix2shape_norm_p)
    return out


class DensePoseCseHeads(nn.Module):
    """Pool (28 x 28 on p2-p5, the gather pooler) + v1-convX ``head`` +
    embedding ``predictor`` over FPN features: the CSE counterpart of
    ``densepose.DensePoseHeads``. Train: fg ROI boxes, per-ROI points
    (flattened to B*R rows), coarse GT and the mesh embeddings -> the loss
    dict. Inference: {embedding, coarse_segm} per ROI (B, R, C, S, S)."""

    def __init__(self, cfg: CSEConfig, in_channels: int, head_convs: int = 8,
                 head_dim: int = 512, pooler_resolution: int = 28,
                 strides: Tuple[int, ...] = (4, 8, 16, 32), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.pooler_resolution = pooler_resolution
        self.strides = tuple(strides)
        self.dtype = dtype
        self.head = DensePoseV1ConvXHead(
            DensePoseConfig(num_stacked_convs=head_convs, conv_head_dim=head_dim), in_channels)
        self.predictor = DensePoseEmbeddingPredictor(cfg, self.head.out_channels)

    def forward(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor,
                train: bool = False, points: Optional[CsePoints] = None,
                coarse_segm_gt: Optional[torch.Tensor] = None,
                roi_live: Optional[torch.Tensor] = None,
                mesh_embeddings: Optional[Sequence[torch.Tensor]] = None,
                picks: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        pooled = pool_fpn_rois(features, boxes, self.pooler_resolution, self.strides)
        outputs = self.predictor(self.head(pooled.to(self.dtype)))
        if not train:
            b, r, _ = boxes.shape
            return {k: v.reshape(b, r, *v.shape[1:]) for k, v in outputs.items()}
        if points is None or coarse_segm_gt is None or roi_live is None or mesh_embeddings is None:
            raise ValueError("training needs points, coarse_segm_gt, roi_live and mesh_embeddings")
        return densepose_cse_losses(outputs, points, coarse_segm_gt, roi_live.reshape(-1),
                                    mesh_embeddings, self.cfg, picks=picks, generator=generator)


def cse_nearest_vertices(embedding_map: torch.Tensor, coarse_segm: torch.Tensor,
                         mesh_embeddings: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel nearest mesh vertex and foreground of ROIs (N, D, S, S) /
    (N, C, S, S) -> (N, S, S) int32 ids, (N, S, S) bool. One ROI at a time:
    its (S^2, K) distance matrix is 1.4 GB at S = 112 and 27554 vertices."""
    n, d, s, _ = embedding_map.shape
    ids = []
    for i in range(n):
        e = normalize_embeddings(embedding_map[i].reshape(d, s * s).T)
        d2 = squared_euclidean_distance_matrix(e, mesh_embeddings)
        ids.append(torch.argmin(d2, dim=-1).to(torch.int32).reshape(s, s))
    fg = torch.argmax(coarse_segm, dim=1) > 0
    return torch.stack(ids), fg
