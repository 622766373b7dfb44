"""Semi-supervised fine-tuning: FixMatch and SimCLRv2-style fine-tuning of
the USL-selected labeled subsets (counterpart of
``u2seg_tpu/pseudo/semisup.py``; U2Seg's ``semisup-fixmatch-cifar`` and
``semisup-simclrv2``).

- One FixMatch step runs ONE forward over the concatenated labeled, weak
  and strong batches, so BatchNorm takes joint statistics (the reference's
  interleave exists only for that); nothing is interleaved.
- The EMA is a pure update of the parameters (not the BN buffers), as the
  JAX package's tree map over ``params``.
- The strong augmentation (RandAugmentMC, n=2, m=10) runs on the host in
  numpy, with OpenCV's warp and blur taken from ``data/warp.py``: for the
  same ``RandomState`` it returns the JAX function's image bit for bit.
- The optimizer is any ``torch.optim`` optimizer; ``torch.optim.SGD`` with
  momentum does ``optax.sgd(lr, momentum)``'s arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from u2seg_torch.data import warp


# ---------------------------------------------------------------------------
# FixMatch loss + step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FixMatchConfig:
    """FixMatch's defaults: threshold 0.95, T 1.0, lambda_u 1.0, mu 7
    (unlabeled:labeled batch ratio), EMA decay 0.999."""

    threshold: float = 0.95
    temperature: float = 1.0
    lambda_u: float = 1.0
    mu: int = 7
    ema_decay: float = 0.999


def fixmatch_losses(logits_x: torch.Tensor, targets_x: torch.Tensor,
                    logits_u_w: torch.Tensor, logits_u_s: torch.Tensor,
                    cfg: FixMatchConfig) -> Dict[str, torch.Tensor]:
    """Lx = CE of the labeled logits; pseudo-labels from the weak view
    (no gradient) sharpened by T; Lu = the mean over ALL unlabeled rows of
    the strong view's CE against them, masked by max-prob >= threshold."""
    logp_x = F.log_softmax(logits_x, dim=-1)
    lx = -torch.mean(torch.gather(logp_x, 1, targets_x[:, None].long()))
    pseudo = F.softmax(logits_u_w.detach() / cfg.temperature, dim=-1)
    max_probs = pseudo.amax(dim=-1)
    targets_u = torch.argmax(pseudo, dim=-1)
    mask = (max_probs >= cfg.threshold).to(logits_u_s.dtype)
    logp_s = F.log_softmax(logits_u_s, dim=-1)
    ce_u = -torch.gather(logp_s, 1, targets_u[:, None])[:, 0]
    lu = torch.mean(ce_u * mask)
    return {"loss_x": lx, "loss_u": lu * cfg.lambda_u, "mask_rate": torch.mean(mask)}


Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def _params(p: Params) -> Dict[str, torch.Tensor]:
    return dict(p.named_parameters()) if isinstance(p, nn.Module) else dict(p)


@torch.no_grad()
def ema_update(ema_params: Params, params: Params, decay: float) -> Dict[str, torch.Tensor]:
    """``ema <- decay * ema + (1 - decay) * params`` in place, over the
    parameters (a module's, or a dict of tensors by name). Returns the EMA
    tensors by name."""
    ema, cur = _params(ema_params), _params(params)
    for name, e in ema.items():
        e.copy_(e * decay + cur[name].to(e.dtype) * (1.0 - decay))
    return ema


def make_fixmatch_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                             cfg: FixMatchConfig = FixMatchConfig()):
    """-> ``step(images_x, targets_x, images_u_w, images_u_s)``: one FixMatch
    update of ``model`` (which maps images to logits) by ``optimizer``, then
    the EMA. Returns the losses, ``mask_rate`` and their sum ``loss``
    (detached). The EMA copy of the parameters starts at the model's and is
    ``step.ema_params`` (by name)."""
    ema_params = {n: p.detach().clone() for n, p in model.named_parameters()}

    def step(images_x, targets_x, images_u_w, images_u_s):
        model.train()
        bx, bw = images_x.shape[0], images_u_w.shape[0]
        logits = model(torch.cat([images_x, images_u_w, images_u_s], 0))
        losses = fixmatch_losses(logits[:bx], targets_x, logits[bx:bx + bw],
                                 logits[bx + bw:], cfg)
        total = losses["loss_x"] + losses["loss_u"]
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        ema_update(ema_params, model, cfg.ema_decay)
        out = {k: v.detach() for k, v in losses.items()}
        out["loss"] = total.detach()
        return out

    step.ema_params = ema_params
    return step


# ---------------------------------------------------------------------------
# RandAugmentMC (strong augmentation, host-side numpy)
# ---------------------------------------------------------------------------

def _blend(a: np.ndarray, b: np.ndarray, f: float) -> np.ndarray:
    return np.clip(a + (b - a) * f, 0, 255).astype(np.uint8)


def _affine(img: np.ndarray, mat: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    return warp.warp_affine(img, mat[:2], (w, h), "nearest", (128, 128, 128))


def randaugment_mc(img: np.ndarray, rng: np.random.RandomState,
                   n: int = 2, m: int = 10) -> np.ndarray:
    """RandAugmentMC(n, m) of a uint8 (H, W, 3) image: n ops drawn from
    FixMatch's pool, each at a magnitude drawn up to m, then a gray cutout.
    Pixel ops in numpy, geometric ops as nearest affine warps with the gray
    (128) fill; draws from ``rng`` in the JAX function's order."""
    img = np.asarray(img, np.uint8).copy()
    gray = lambda x: x.mean(-1, keepdims=True).repeat(3, -1)  # noqa: E731

    def autocontrast(x, _):
        lo = x.min(axis=(0, 1), keepdims=True).astype(np.float32)
        hi = x.max(axis=(0, 1), keepdims=True).astype(np.float32)
        scale = 255.0 / np.maximum(hi - lo, 1.0)
        return np.clip((x - lo) * scale, 0, 255).astype(np.uint8)

    def brightness(x, v):
        return _blend(np.zeros_like(x), x, v)

    def color(x, v):
        return _blend(gray(x), x, v)

    def contrast(x, v):
        return _blend(np.full_like(x, int(x.mean())), x, v)

    def equalize(x, _):
        out = x.copy()
        for c in range(3):
            hist = np.bincount(x[..., c].ravel(), minlength=256)
            nz = hist[hist > 0]
            if len(nz) <= 1:
                continue
            step = (hist.sum() - nz[-1]) // 255
            if step == 0:
                continue
            lut = np.clip((np.cumsum(hist) - hist // 2) // step, 0, 255)
            out[..., c] = lut[x[..., c]]
        return out.astype(np.uint8)

    def identity(x, _):
        return x

    def posterize(x, v):
        bits = int(v)
        return (x >> (8 - bits)) << (8 - bits)

    def sharpness(x, v):
        return _blend(warp.blur3x3(x), x, v)

    def solarize(x, v):
        return np.where(x < int(v), x, 255 - x).astype(np.uint8)

    def rotate(x, v):
        h, w = x.shape[:2]
        mat = warp.get_rotation_matrix_2d((w / 2, h / 2), v, 1.0)
        return _affine(x, np.vstack([mat, [0, 0, 1]]))

    def shear_x(x, v):
        return _affine(x, np.array([[1, v, 0], [0, 1, 0], [0, 0, 1]], np.float32))

    def shear_y(x, v):
        return _affine(x, np.array([[1, 0, 0], [v, 1, 0], [0, 0, 1]], np.float32))

    def translate_x(x, v):
        return _affine(x, np.array(
            [[1, 0, v * x.shape[1]], [0, 1, 0], [0, 0, 1]], np.float32))

    def translate_y(x, v):
        return _affine(x, np.array(
            [[1, 0, 0], [0, 1, v * x.shape[0]], [0, 0, 1]], np.float32))

    # (op, max_v, bias): FixMatch's fixmatch_augment_pool
    pool = [
        (autocontrast, None, None), (brightness, 0.9, 0.05),
        (color, 0.9, 0.05), (contrast, 0.9, 0.05), (equalize, None, None),
        (identity, None, None), (posterize, 4, 4), (rotate, 30, 0),
        (sharpness, 0.9, 0.05), (shear_x, 0.3, 0), (shear_y, 0.3, 0),
        (solarize, 256, 0), (translate_x, 0.3, 0), (translate_y, 0.3, 0),
    ]
    for op, max_v, bias in [pool[i] for i in rng.randint(0, len(pool), n)]:
        v = None
        if max_v is not None:
            v = float(rng.randint(1, m + 1)) / 10.0 * max_v + bias
            if op in (rotate, shear_x, shear_y, translate_x, translate_y) \
                    and rng.rand() < 0.5:
                v = -v
        img = op(img, v)
    # the cutout: a fixed-size gray square, always last
    h, w = img.shape[:2]
    cut = max(min(h, w) // 2 * 2 // 4, 2)
    cy, cx = rng.randint(0, h), rng.randint(0, w)
    y0, y1 = max(cy - cut // 2, 0), min(cy + cut // 2, h)
    x0, x1 = max(cx - cut // 2, 0), min(cx + cut // 2, w)
    img[y0:y1, x0:x1] = 127
    return img


# ---------------------------------------------------------------------------
# SimCLRv2-style fine-tuning
# ---------------------------------------------------------------------------

def make_finetune_train_step(backbone: nn.Module, head: nn.Module,
                             optimizer: torch.optim.Optimizer,
                             freeze_backbone: bool = False) -> Callable:
    """-> ``step(images, targets)``: supervised fine-tuning of a pretrained
    trunk (images -> (N, D) features) and a classifier head (features ->
    (N, C) logits) by CE. With ``freeze_backbone`` no gradient reaches the
    trunk: its gradients are set to zeros (not dropped), as the JAX
    package zeroes them, so the optimizer sees the same state. Returns
    ``loss`` and ``top1`` (detached)."""

    def step(images, targets):
        feats = backbone(images)
        if freeze_backbone:
            feats = feats.detach()
        logits = head(feats)
        logp = F.log_softmax(logits, dim=-1)
        loss = -torch.mean(torch.gather(logp, 1, targets[:, None].long()))
        acc = torch.mean((torch.argmax(logits, -1) == targets).float())
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if freeze_backbone:
            for p in backbone.parameters():
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return {"loss": loss.detach(), "top1": acc.detach()}

    return step
