"""ViTDet's trunk and simple feature pyramid, written out.

The ViT (Li, Mao, Girshick and He, ECCV 2022; detectron2's
``projects/ViTDet``) on (B, H, W, C) token maps:

- tokens: a p x p stride-p patch conv, then a learned ``pos_embed`` of shape
  (1, gh, gw, dim) added (the grid of the run's input: detectron2 brings
  MAE's 14 x 14 table and interpolates it with ``get_abs_pos``; at seeded
  weights both are a learned table);
- blocks: ``x = x + drop_path(attn(norm1(x)))``, ``x = x + drop_path(mlp(
  norm2(x)))``, LayerNorm eps 1e-6, an MLP with exact GELU; windowed
  blocks zero-pad the normed map to a multiple of the window and attend
  inside each window (padded keys unmasked), global blocks over the grid;
- attention: ``softmax(q k^T * d^-0.5 + bias) v`` with the decomposed
  relative positions ``bias[qh, qw, kh, kw] = rel_h[qh, qw, kh] + rel_w[qh,
  qw, kw]``, ``rel_h = einsum("bhwc,hkc->bhwk", q, R_h)`` on the unscaled q,
  ``R_h[i, j] = rel_pos_h[i - j + k - 1]`` (and the same for w); a block's
  tables are (2 * side - 1, head dim) for the side it attends over;
- stochastic depth: block i drops each branch of a sample with probability
  ``linspace(0, rate, depth)[i]``, keeps scaled by 1 / keep; the keep masks
  are ``bernoulli_(keep)`` on an f32 (B,) tensor, drawn from the step's
  generator block by block, the attention branch first, both before the
  block computes (blocks at rate 0 draw nothing).

The pyramid: p2 = deconv, LN, GELU, deconv; p3 = deconv; p4 = the map; p5 =
a 2 x 2 max-pool; each then a 1 x 1 and a 3 x 3 conv of ``out`` channels,
each with a channel LayerNorm; p6 = p5 at stride 2.

Precision (``dtype``; bf16 in the cell, f32 for the f32 reference): the
products compute in ``dtype`` from operands cast to it (patch conv, qkv,
the relative-position einsums and the bias, the scores, the attention's
product with v, proj, the MLP's linears and its GELU, the pyramid's
deconvs, convs and GELU); LayerNorm statistics and the softmax compute in
f32 and their results are cast to ``dtype``; the residual stream stays f32.
That is the rule the port's ``vit.py`` states (detectron2 trains under fp16
autocast, which keeps the same things in f32). A ``quantize`` (the control)
rounds every tensor held in ``dtype``.

``checkpoint`` recomputes each block in the backward
(``torch.utils.checkpoint``; the drop masks are drawn before, so the
recomputation is the same function): the reference's f32 replay keeps one
block's activations at a time. The global blocks' attention runs in chunks
of (image, head) rows, the same sums. Two faults can be planted:
``rel_pos_off`` (the bias left out) and ``global_windowed`` (the global
blocks attend inside windows, with the middle rows of their tables).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from portbench.refmodel.layers import Conv2d, ConvTranspose2d, Linear

# the most score elements one attention chunk holds
CHUNK_ELEMENTS = 1 << 28


def _q(mod, x):
    q = getattr(mod, "quantize", None)
    return x if q is None else q(x)


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map, in f32, cast back."""

    quantize = None

    def forward(self, x):
        y = F.layer_norm(x.permute(0, 2, 3, 1).float(), self.normalized_shape,
                         self.weight, self.bias, self.eps)
        return _q(self, y.permute(0, 3, 1, 2).to(x.dtype))


def windows(x: torch.Tensor, ws: int):
    """(B, H, W, C) zero-padded at the bottom and right to multiples of
    ``ws``, cut into (B * n, ws, ws, C) windows; also the padded size."""
    b, h, w, c = x.shape
    hp, wp = h + (-h) % ws, w + (-w) % ws
    x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
    x = x.view(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def unwindows(x: torch.Tensor, ws: int, padded, hw) -> torch.Tensor:
    hp, wp = padded
    b = x.shape[0] // ((hp // ws) * (wp // ws))
    x = x.view(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :hw[0], :hw[1]]


def rel_table(side: int, table: torch.Tensor) -> torch.Tensor:
    """R[i, j] = table[i - j + side - 1] for i, j < side, from the table's
    middle rows where it was made for a longer side."""
    mid = (table.shape[0] - 1) // 2
    i = torch.arange(side, device=table.device)
    return table[i[:, None] - i[None, :] + mid]


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, side: Optional[Tuple[int, int]]):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.rel_pos = side is not None
        self.rel_pos_off = False
        self.quantize = None
        if self.rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * side[0] - 1, dim // heads))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * side[1] - 1, dim // heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        n, d = h * w, c // self.heads
        qkv = self.qkv(x.reshape(b, n, c)).view(b, n, 3, self.heads, d)
        q, k, v = (_q(self, t.reshape(b * self.heads, n, d))
                   for t in qkv.permute(2, 0, 3, 1, 4).unbind(0))
        out = []
        rows = max(1, CHUNK_ELEMENTS // (n * n))
        for s in range(0, b * self.heads, rows):
            qs, ks, vs = q[s:s + rows], k[s:s + rows], v[s:s + rows]
            scores = (qs * d ** -0.5) @ ks.transpose(1, 2)
            if self.rel_pos and not self.rel_pos_off:
                rq = qs.reshape(-1, h, w, d)
                rh = torch.einsum("bhwc,hkc->bhwk", rq, _q(self, rel_table(h, self.rel_pos_h)
                                                         .to(q.dtype)))
                rw = torch.einsum("bhwc,wkc->bhwk", rq, _q(self, rel_table(w, self.rel_pos_w)
                                                         .to(q.dtype)))
                bias = _q(self, (rh[:, :, :, :, None] + rw[:, :, :, None, :]).reshape(-1, n, n))
                scores = scores + bias
            probs = _q(self, torch.softmax(scores.float(), dim=-1).to(v.dtype))
            out.append(_q(self, probs @ vs))
        out = torch.cat(out).view(b, self.heads, n, d).transpose(1, 2).reshape(b, n, c)
        return self.proj(out).view(b, h, w, c)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)
        self.quantize = None

    def forward(self, x):
        return self.fc2(_q(self, F.gelu(self.fc1(x))))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, side, rate: float, dtype,
                 fault_window: int):
        super().__init__()
        self.window, self.rate, self.dtype = window, rate, dtype
        self.fault_window = fault_window             # a global block's, windowed
        self.global_windowed = False
        self.quantize = None
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, side)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)

    def masks(self, b: int, device, generator):
        """The keep scales of the two branches (None: nothing dropped)."""
        if not self.training or self.rate <= 0:
            return None, None
        keep = 1.0 - self.rate
        return tuple(torch.empty(b, dtype=torch.float32, device=device)
                     .bernoulli_(keep, generator=generator) / keep for _ in range(2))

    def compute(self, x, m_attn, m_mlp):
        y = _q(self, self.norm1(x).to(self.dtype))
        ws = self.window or (self.fault_window if self.global_windowed else 0)
        if ws:
            hw = y.shape[1:3]
            y, padded = windows(y, ws)
            y = unwindows(self.attn(y), ws, padded, hw)
        else:
            y = self.attn(y)
        x = x + (y if m_attn is None else y * m_attn.view(-1, 1, 1, 1))
        y = self.mlp(_q(self, self.norm2(x).to(self.dtype)))
        return x + (y if m_mlp is None else y * m_mlp.view(-1, 1, 1, 1))


class ViT(nn.Module):
    def __init__(self, grid: Tuple[int, int], patch: int, dim: int, depth: int, heads: int,
                 window: int, global_blocks: Sequence[int], rel_pos: bool,
                 drop_path_rate: float, dtype=torch.float32):
        super().__init__()
        self.patch, self.dtype = patch, dtype
        self.checkpoint = False
        self.patch_embed = nn.Module()
        self.patch_embed.proj = Conv2d(3, dim, patch, stride=patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, *grid, dim))
        rates = torch.linspace(0, drop_path_rate, depth).tolist()
        self.blocks = nn.ModuleList()
        for i in range(depth):
            ws = 0 if i in global_blocks else window
            side = ((ws, ws) if ws else tuple(grid)) if rel_pos else None
            self.blocks.append(Block(dim, heads, ws, side, rates[i], dtype, window))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = self.patch_embed.proj(x.to(self.dtype)).permute(0, 2, 3, 1)
        x = x.float() + self.pos_embed
        for blk in self.blocks:
            m = blk.masks(x.shape[0], x.device, generator)
            if self.checkpoint and torch.is_grad_enabled():
                from torch.utils.checkpoint import checkpoint

                x = checkpoint(blk.compute, x, *m, use_reentrant=False)
            else:
                x = blk.compute(x, *m)
        return x


def _level_convs(cin: int, out: int):
    return [Conv2d(cin, out, 1, bias=False, norm=LayerNorm2d(out, eps=1e-6)),
            Conv2d(out, out, 3, padding=1, bias=False, norm=LayerNorm2d(out, eps=1e-6))]


class ViTDet(nn.Module):
    """The trunk (``net``) and the pyramid (``simfp_2`` .. ``simfp_5``):
    {"p2".."p6"} NCHW maps in the trunk's dtype."""

    def __init__(self, vit: ViT, out: int = 256):
        super().__init__()
        self.net = vit
        dim = vit.pos_embed.shape[-1]
        self.simfp_2 = nn.Sequential(
            ConvTranspose2d(dim, dim // 2, 2, stride=2), LayerNorm2d(dim // 2, eps=1e-6),
            nn.GELU(), ConvTranspose2d(dim // 2, dim // 4, 2, stride=2),
            *_level_convs(dim // 4, out))
        self.simfp_3 = nn.Sequential(ConvTranspose2d(dim, dim // 2, 2, stride=2),
                                     *_level_convs(dim // 2, out))
        self.simfp_4 = nn.Sequential(*_level_convs(dim, out))
        self.simfp_5 = nn.Sequential(nn.MaxPool2d(2, 2), *_level_convs(dim, out))

    def forward(self, x: torch.Tensor, generator=None) -> Dict[str, torch.Tensor]:
        feat = self.net(x, generator).to(self.net.dtype).permute(0, 3, 1, 2)
        out = {f"p{lvl}": getattr(self, f"simfp_{lvl}")(feat) for lvl in range(2, 6)}
        out["p6"] = out["p5"][:, :, ::2, ::2]
        return out
