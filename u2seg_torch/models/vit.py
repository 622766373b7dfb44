"""ViTDet: a plain ViT trunk and its SimpleFeaturePyramid (counterpart of
``u2seg_tpu/models/vit.py``).

The trunk works on (B, H, W, C) token maps as the JAX module does: a p x p
stride-p patch conv (flax's SAME padding), a learned ``pos_embed`` of shape
(1, gh, gw, dim), then blocks of windowed attention (zero padding after
``norm1``, padded keys unmasked) with a few global blocks. LayerNorm eps
1e-6, exact-erf GELU, and ``pos_embed`` made for one grid: the grid of the
input the model was built for (``build_backbone``'s ``input_hw``); a forward
at another grid raises, as the JAX module does when applied to its
parameters.

By default it follows the JAX module where that differs from detectron2's
ViT: no relative position term, no stochastic depth, attention in plain ops
(scale q, ``q @ k^T``, softmax, ``@ v``), and everything in f32 whatever the
input's dtype (the JAX package builds the trunk and the pyramid with no
dtype: flax promotes a bf16 image to the f32 parameters), the maps out in
f32. Four switches (``BackboneConfig``) give detectron2's ViTDet instead:

- ``rel_pos``: ``add_decomposed_rel_pos``. With q unscaled, ``rel_h =
  einsum("bhwc,hkc->bhwk", q, R_h)`` and ``rel_w`` the same with ``R_w``,
  where ``R_h[i, j] = rel_pos_h[i - j + k_h - 1]``; the bias ``rel_h[..., kh,
  None] + rel_w[..., None, kw]`` is added to the scaled scores. A block's
  tables are (2 * side - 1, head dim) for the side it attends over (the
  window, or the grid in a global block), so no table is interpolated.
- ``drop_path_rate``: stochastic depth in training. Block i drops each of
  its two residual branches per sample with probability ``linspace(0,
  rate, depth)[i]`` and scales a kept one by 1 / keep; the keep masks are
  ``bernoulli_(keep)`` on an f32 (B,) tensor drawn from the step's
  generator, block by block, the attention branch first (blocks at rate 0
  draw nothing).
- ``sdpa``: attention through ``F.scaled_dot_product_attention``, the
  relative-position bias as its ``attn_mask``.
- ``compute_dtype`` (bf16 under ``vit_in_compute_dtype``): the products
  compute in it (patch conv, qkv, the relative-position einsums and the
  bias, attention, proj, the MLP's linears and GELU, the pyramid's deconvs
  and convs), their weights cast to it as the port's layers do; LayerNorm
  statistics compute in f32 (the result cast back to the compute dtype),
  the plain attention's softmax in f32, and the residual stream (``x +
  branch``) stays f32: what ``torch.autocast`` would keep. The pyramid's
  levels leave in the compute dtype.

Names are detectron2's: ``net.patch_embed.proj``, ``net.pos_embed``,
``net.blocks.{i}.{norm1,attn.qkv,attn.proj,attn.rel_pos_h,attn.rel_pos_w,
norm2,mlp.fc1,mlp.fc2}``, and the pyramid's ``simfp_{2..5}`` Sequentials
(``simfp_2``: deconv, LN, GELU, deconv, then the 1x1 and 3x3 convs each
with its ``.norm``).

Spans (``utils/spans.py``), inside ``u2s.backbone``: ``u2s.vit.patch``
(patch conv and ``pos_embed``), ``u2s.vit.attn.window`` and
``u2s.vit.attn.global`` (a block's attention: partition, qkv, bias,
attention, proj), ``u2s.vit.mlp``, and ``u2s.backbone.pyramid``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from u2seg_torch.models.layers import Conv2d
from u2seg_torch.ops.norms import LayerNorm2d
from u2seg_torch.utils.spans import span


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> (B * windows, ws, ws, C), zero-padded at the bottom
    and right to multiples of ``ws``; also the padded (Hp, Wp)."""
    b, h, w, c = x.shape
    ph, pw = (-h) % ws, (-w) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(x: torch.Tensor, ws: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // ((hp // ws) * (wp // ws))
    x = x.view(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


def same_pad(x: torch.Tensor, k: int) -> torch.Tensor:
    """flax's SAME padding of an NCHW map for a k x k conv of stride k."""
    h, w = x.shape[2:]
    th, tw = (-h) % k, (-w) % k
    if th == tw == 0:
        return x
    return F.pad(x, (tw // 2, tw - tw // 2, th // 2, th - th // 2))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias=None) -> torch.Tensor:
    """softmax((q * d^-0.5) @ k^T (+ bias)) @ v over (..., N, d) heads; the
    softmax in f32, its result in v's dtype."""
    attn = (q * q.shape[-1] ** -0.5) @ k.transpose(-2, -1)
    if bias is not None:
        attn = attn + bias
    return torch.softmax(attn.float(), dim=-1).to(v.dtype) @ v


def get_rel_pos(size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(size, size, d): entry (i, j) is ``rel_pos[i - j + size - 1]``."""
    if rel_pos.shape[0] != 2 * size - 1:
        raise ValueError(f"a relative-position table of {rel_pos.shape[0]} rows "
                         f"for a side of {size}: the port does not interpolate")
    idx = torch.arange(size, device=rel_pos.device)
    return rel_pos[idx[:, None] - idx[None, :] + (size - 1)]


def decomposed_rel_pos(q: torch.Tensor, hw: Tuple[int, int], rel_pos_h: torch.Tensor,
                       rel_pos_w: torch.Tensor) -> torch.Tensor:
    """detectron2's ``add_decomposed_rel_pos`` as a bias: q (B, heads, h*w,
    d), unscaled -> (B, heads, h*w, h*w) in q's dtype."""
    b, n_heads, n, d = q.shape
    h, w = hw
    r_q = q.reshape(b * n_heads, h, w, d)
    # contiguous terms give a contiguous sum, which the reshape only views
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, get_rel_pos(h, rel_pos_h).to(q.dtype))
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, get_rel_pos(w, rel_pos_w).to(q.dtype))
    bias = rel_h.contiguous()[:, :, :, :, None] + rel_w.contiguous()[:, :, :, None, :]
    return bias.reshape(b, n_heads, n, n)


def drop_path(branch: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """``branch`` (B, ...) with each sample kept with probability 1 - rate
    and scaled by 1 / (1 - rate), else zero; the keep mask is
    ``bernoulli_`` on an f32 (B,) tensor drawn from ``generator``. The result
    is f32 (it joins the residual stream)."""
    keep = 1.0 - rate
    mask = torch.empty(branch.shape[0], dtype=torch.float32,
                       device=branch.device).bernoulli_(keep, generator=generator)
    scale = (mask / keep).view(-1, *([1] * (branch.dim() - 1)))
    return branch * scale


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` with its weight and bias in ``x``'s dtype."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _deconv2d(layer: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv_transpose2d(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype),
                              layer.stride)


class _Deconv(nn.ConvTranspose2d):
    """A 2x2 stride-2 transposed conv in its input's dtype."""

    def forward(self, x):
        return _deconv2d(self, x)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return _linear(self.fc2, F.gelu(_linear(self.fc1, x)))


class ViTAttention(nn.Module):
    """Multi-head self-attention over a (B, H, W, C) map; with ``rel_pos``
    (the (h, w) it attends over) the decomposed relative positions."""

    def __init__(self, dim: int, num_heads: int, rel_pos: Optional[Tuple[int, int]] = None,
                 sdpa: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.sdpa = sdpa
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.use_rel_pos = rel_pos is not None
        if self.use_rel_pos:
            head_dim = dim // num_heads
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * rel_pos[0] - 1, head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * rel_pos[1] - 1, head_dim))

    def forward(self, x):
        b, h, w, c = x.shape
        n = h * w
        qkv = _linear(self.qkv, x.reshape(b, n, c)).view(b, n, 3, self.num_heads, -1)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        bias = (decomposed_rel_pos(q, (h, w), self.rel_pos_h, self.rel_pos_w)
                if self.use_rel_pos else None)
        if self.sdpa:
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        else:
            out = attention(q, k, v, bias)
        return _linear(self.proj, out.transpose(1, 2).reshape(b, n, c)).view(b, h, w, c)


class ViTBlock(nn.Module):
    """``x + drop_path(attn(norm1(x)))``, then ``x + drop_path(mlp(norm2(x)))``;
    the residual stream in f32, the branches in ``dtype``."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 0,
                 mlp_ratio: float = 4.0, rel_pos: Optional[Tuple[int, int]] = None,
                 drop_path: float = 0.0, sdpa: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size = window_size          # 0: global attention
        self.drop_path = drop_path
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = ViTAttention(dim, num_heads, rel_pos, sdpa)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _branch(self, y, generator):
        if self.training and self.drop_path > 0:
            return drop_path(y, self.drop_path, generator)
        return y

    def forward(self, x, generator=None):
        y = self.norm1(x).to(self.dtype)
        if self.window_size > 0:
            with span("u2s.vit.attn.window"):
                hw = y.shape[1:3]
                y, pad_hw = window_partition(y, self.window_size)
                y = window_unpartition(self.attn(y), self.window_size, pad_hw, hw)
        else:
            with span("u2s.vit.attn.global"):
                y = self.attn(y)
        x = x + self._branch(y, generator)
        y = self.norm2(x).to(self.dtype)
        with span("u2s.vit.mlp"):
            y = self.mlp(y)
        return x + self._branch(y, generator)


class ViT(nn.Module):
    """ViT-B/16 trunk by default; ``grid`` is the (gh, gw) token grid that
    ``pos_embed`` is made for. ``rel_pos``, ``drop_path_rate``, ``sdpa`` and
    ``dtype`` are the switches of the module doc (off, and f32, by default).
    Returns the stride-p map as (B, gh, gw, dim), f32."""

    def __init__(self, grid: Tuple[int, int], patch_size: int = 16, dim: int = 768,
                 depth: int = 12, num_heads: int = 12, window_size: int = 14,
                 global_blocks: Sequence[int] = (2, 5, 8, 11), rel_pos: bool = False,
                 drop_path_rate: float = 0.0, sdpa: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, *grid, dim))
        rates = torch.linspace(0, drop_path_rate, depth).tolist()
        blocks = []
        for i in range(depth):
            ws = 0 if i in global_blocks else window_size
            side = (ws, ws) if ws else tuple(grid)
            blocks.append(ViTBlock(dim, num_heads, ws, rel_pos=side if rel_pos else None,
                                   drop_path=rates[i], sdpa=sdpa, dtype=dtype))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        p = self.patch_size
        with span("u2s.vit.patch"):
            proj = self.patch_embed.proj
            x = same_pad(x.to(self.dtype), p)
            x = F.conv2d(x, proj.weight.to(x.dtype), proj.bias.to(x.dtype),
                         proj.stride).permute(0, 2, 3, 1)
            if x.shape[1:3] != self.pos_embed.shape[1:3]:
                raise ValueError(
                    f"ViT: a {tuple(x.shape[1:3])} token grid, but pos_embed is made for "
                    f"{tuple(self.pos_embed.shape[1:3])}: build the model for this input size")
            x = x.float() + self.pos_embed
        for blk in self.blocks:
            x = blk(x, generator)
        return x


class ViTDet(nn.Module):
    """ViT + SimpleFeaturePyramid: {"p2".."p6"} NCHW maps (channels-last
    memory) from the single stride-16 map, in the trunk's dtype. p2 and p3
    come from 2x2 stride-2 transposed convs (flax's, unflipped:
    ``weights.from_jax`` flips them), p5 from a 2x2 max-pool, p6 from p5 by
    a 1x1 stride-2 max-pool. ``forward`` takes the step's generator
    (``takes_generator``), which stochastic depth draws from."""

    takes_generator = True

    def __init__(self, vit: ViT, out_channels: int = 256,
                 scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5)):
        super().__init__()
        self.net = vit
        dim = vit.pos_embed.shape[-1]
        for scale, lvl in zip(scale_factors, range(2, 6)):
            if scale == 4.0:
                layers = [_Deconv(dim, dim // 2, 2, stride=2), LayerNorm2d(dim // 2, eps=1e-6),
                          nn.GELU(), _Deconv(dim // 2, dim // 4, 2, stride=2)]
                cin = dim // 4
            elif scale == 2.0:
                layers, cin = [_Deconv(dim, dim // 2, 2, stride=2)], dim // 2
            elif scale == 1.0:
                layers, cin = [], dim
            elif scale == 0.5:
                layers, cin = [nn.MaxPool2d(2, 2)], dim
            else:
                raise ValueError(f"scale factor {scale} is not supported")
            layers += [
                Conv2d(cin, out_channels, 1, bias=False,
                       norm=LayerNorm2d(out_channels, eps=1e-6)),
                Conv2d(out_channels, out_channels, 3, padding=1, bias=False,
                       norm=LayerNorm2d(out_channels, eps=1e-6)),
            ]
            self.add_module(f"simfp_{lvl}", nn.Sequential(*layers))

    def forward(self, x: torch.Tensor, generator=None) -> Dict[str, torch.Tensor]:
        feat = self.net(x, generator).to(self.net.dtype).permute(0, 3, 1, 2)
        with span("u2s.backbone.pyramid"):
            out = {f"p{lvl}": getattr(self, f"simfp_{lvl}")(feat) for lvl in range(2, 6)}
            out["p6"] = out["p5"][:, :, ::2, ::2]
        return out
