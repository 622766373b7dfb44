"""The plain reference of a training cell, and the numbers that decide
``correct``.

``replay`` builds the reference model (``portbench.refmodel``) from the
configuration file and the seed, as the port's trainer builds its own, and
follows the program's first steps on the same batches, with the same
sampling draws and the program's proposals (which, at seeded weights, an
objectness a rounding apart reorders): in f32 with TF32 off, or at the
configuration's own compute dtype. ``control_replay`` is the control: the
reference put in the program's place one precision below the
configuration's (fp8 products for a bf16 configuration, bf16 for an f32
one); ``replay`` with a ``fault`` of ``FAULTS`` plants a fault in it.
``Readings`` are what a side gives: each step's losses and RPN head
outputs, the first gradient as the optimizer got it (from its momentum
after one step, less the weight decay), and each leaf's change after the
steps.

``compare`` turns two readings into numbers; ``compare_both`` takes them
against the f32 reference and, suffixed ``_bf16``, against the reference at
the configuration's own compute dtype (the same reference where that is
f32):
- ``init_gap``: the largest relative gap of a leaf's norm before the first
  step (the start, which both sides draw from the seed: exact);
- ``loss_gap``: the largest relative gap of a step's total loss;
- ``rpn_head_gap``: the larger relative gap (norm of the difference over
  the reference's norm, all levels together) of the RPN head's objectness
  logits or anchor deltas in the first step: the trunk's and the head's
  forward on the same weights, whose outputs the proposal stage reads;
- ``grad_scale``: how far the median leaf's ratio of the two sides' norms
  of the first gradient lies from 1 (a gradient scaled as a whole);
  ``update_scale``: the same of each leaf's change after the steps (a
  learning rate, a warm-up factor);
- ``grad_gap``: per leaf, how far that ratio lies from the median ratio; the
  median of that within each part of the model (``leaf_part``), and the
  largest over the parts (a fault of one head's backward); ``update_gap``:
  the same of each leaf's change;
- ``grad_angle`` / ``update_angle``: per leaf, 1 - the cosine between the
  two sides' tensors; the median within each part, the largest over the
  parts (a change of sign or direction, which norms do not see).
The median within a part, not the worst leaf: the worst leaves are the early
norms' parameters, whose gradients cancel to a few thousandths of their
parts, and weights at 1.0 that move by less than their ulp in the warm-up's
first steps, and a box stage's regression leaves (``leaf_part``). Leaves the reference gives no gradient (frozen) and leaves
whose first gradient is under a thousandth of the median leaf's (they move
by rounding) are left out, by that rule on the reference and not by name.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

# leaves whose first gradient (reference) is under this share of the median
# leaf's are left out of the leaf numbers
NOUGHT_SHARE = 1e-3


@dataclass
class Readings:
    losses: List[Dict[str, float]] = field(default_factory=list)   # per step
    init_norms: Dict[str, float] = field(default_factory=dict)     # before the first step
    # per leaf; a leaf the optimizer got no gradient for is left out
    grad_norms: Dict[str, float] = field(default_factory=dict)     # first gradient
    update_norms: Dict[str, float] = field(default_factory=dict)   # change after the steps
    # the same leaves' tensors, f32 on the host
    grads: Dict[str, torch.Tensor] = field(default_factory=dict)
    updates: Dict[str, torch.Tensor] = field(default_factory=dict)
    # per step: the RPN head's (objectness logits, anchor deltas), each a
    # list over the levels, as the head gave them
    rpn_heads: List[tuple] = field(default_factory=list)


def sampling_seed(seed: int, rank: int, step: int) -> int:
    """The seed of one step's sampling generator, as the port's trainer draws
    it: a hash of (seed, rank, step)."""
    return int(np.random.SeedSequence([seed, rank, step]).generate_state(1, np.uint64)[0])


def trainer_seed(seed: int) -> int:
    return seed if seed >= 0 else 0


class Snapshot:
    """Takes a model's readings around its first steps, for either side:
    ``start`` before the first step, ``after_step(i, losses)`` after each."""

    def __init__(self, model: torch.nn.Module, optimizer, steps: int):
        self.model, self.optimizer, self.steps = model, optimizer, steps
        self.readings = Readings()
        self._p0: Dict[str, torch.Tensor] = {}

    def params(self):
        return [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]

    def start(self) -> None:
        self._p0 = {n: p.detach().clone() for n, p in self.params()}
        self.readings.init_norms = {n: float(p.double().norm()) for n, p in self._p0.items()}

    def after_step(self, i: int, losses: Dict[str, float]) -> None:
        self.readings.losses.append(dict(losses))
        if i == 0:
            decay = {id(p): g["weight_decay"] for g in self.optimizer.param_groups
                     for p in g["params"]}
            for n, p in self.params():
                buf = self.optimizer.state.get(p, {}).get("momentum_buffer")
                if buf is None:                  # no gradient, or no step taken
                    continue
                grad = buf.double() - decay[id(p)] * self._p0[n].double()
                self.readings.grad_norms[n] = float(grad.norm())
                self.readings.grads[n] = grad.float().cpu()
        if i == self.steps - 1:
            for n, p in self.params():
                change = p.detach().double() - self._p0[n].double()
                self.readings.update_norms[n] = float(change.norm())
                self.readings.updates[n] = change.float().cpu()
            self._p0 = {}


def fp8_round(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to fp8 with a per-tensor scale that maps its largest
    magnitude to the format's largest value, returned in ``x``'s dtype."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """Forward: the operand in fp8 (e4m3); backward: its gradient in fp8
    (e5m2), as an fp8 product takes and gives them."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, torch.float8_e5m2)


def fp8_operands(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def _double_lr(cfg):
    import dataclasses

    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, base_lr=2 * cfg.solver.base_lr))


# the faults ``replay`` can plant in the reference put in the program's
# place, and what each does
FAULTS = {
    "lr_x2": "the learning rate doubled",
    "grad_x2": "every gradient doubled before the optimizer",
    "negated_update": "every update applied with its sign flipped",
    "half_batch": "half of the batch left out, the mean taken over the rest",
}


def read_config_file(config_file: str) -> tuple:
    """A configuration file's flattened keys as ``key=value`` overrides, and
    its ``assumed`` values."""
    import yaml

    with open(config_file) as f:
        raw = yaml.safe_load(f)
    flat = [f"{k}={json.dumps(v)}" for k, v in raw.items()
            if k not in ("source", "reduced", "assumed")]
    return flat, raw.get("assumed", {})


def load_reference_config(config_file: str, overrides: List[str]):
    """The configuration file read by the reference's own copy of the
    loader, the compute in f32."""
    from portbench.refmodel.config import load_config

    flat, _ = read_config_file(config_file)
    return load_config(None, flat + list(overrides) + ["model.compute_dtype=float32"])


def at_precision(cfg, compute_dtype: str):
    """``cfg`` with the reference's products in ``compute_dtype``."""
    import dataclasses

    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype=compute_dtype))


def own_precision(cfg, compute_dtype: str):
    """The f32 reference ``cfg`` at the configuration's own compute dtype
    (``cfg`` itself for an f32 configuration)."""
    return cfg if compute_dtype == "float32" else at_precision(cfg, compute_dtype)


def build_reference(cfg, seed: int, tau: float, device) -> torch.nn.Module:
    from portbench.refmodel.init import seeded_init
    from portbench.refmodel.panoptic_fpn import PanopticFPN

    model = PanopticFPN(cfg.model)
    seeded_init(model, seed)
    model = model.to(device)
    scale_cls_score(model, tau)
    return model


def scale_cls_score(model: torch.nn.Module, tau: float) -> None:
    """Scale every box classifier by ``tau`` (the configuration's assumed
    calibration, so that seeded weights give detections)."""
    preds = model.roi_heads.box_predictor
    with torch.no_grad():
        for m in (preds if isinstance(preds, torch.nn.ModuleList) else [preds]):
            m.cls_score.weight.mul_(tau)
            m.cls_score.bias.mul_(tau)


def calibrate_frozen_norms(model: torch.nn.Module, images: torch.Tensor) -> None:
    """Set every frozen BatchNorm's statistics from what reaches it on
    ``images``, in one pass (each layer normalised before the next sees it):
    seeded weights come with no statistics, and without them a FrozenBN
    trunk's activations, and the first updates, grow without bound."""
    def pre(m, inp):
        x = inp[0].float()
        m.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        m.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(pre) for m in model.modules()
             if getattr(m, "frozen", False) and hasattr(m, "running_mean")]
    try:
        with torch.no_grad():
            model.features(images)
    finally:
        for h in hooks:
            h.remove()


@dataclass
class Batch:
    images: torch.Tensor        # (B, H, W, 3) raw RGB, f32
    image_sizes: torch.Tensor   # (B, 2)
    gt: object                  # refmodel.instances.GtInstances
    sem_seg: torch.Tensor       # (B, H, W), 255 = ignore


def batch_from_arrays(b: dict, device) -> Batch:
    """One batch of the loader's stacked arrays, as the trainer feeds it,
    on ``device``."""
    from portbench.refmodel.instances import GtInstances

    t = {k: torch.from_numpy(np.asarray(b[k])).to(device)
         for k in ("image", "image_size", "gt_boxes", "gt_classes", "gt_valid",
                   "gt_masks", "sem_seg")}
    return Batch(t["image"], t["image_size"],
                 GtInstances(t["gt_boxes"], t["gt_classes"], t["gt_valid"], t["gt_masks"]),
                 t["sem_seg"])


def replay(cfg, seed: int, tau: float, batches: List[dict], device,
           quantize: Optional[Callable] = None,
           proposals: Optional[List[tuple]] = None,
           frozen_norms_from: Optional[dict] = None,
           fault: Optional[str] = None) -> Readings:
    """The reference's readings over ``batches``, the loader's arrays of
    the program's first steps, one step each. With ``proposals`` (one
    (boxes, scores, valid) per step) its ROI heads sample from those; with
    ``frozen_norms_from`` (a batch) its frozen norms take their statistics
    from it first, as the program's did; with ``fault`` (a key of
    ``FAULTS``) it runs with that fault."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"no fault {fault!r}")
    # TF32 off for the reference alone: a later run of the program in the
    # same process keeps torch's defaults
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _replay(cfg, seed, tau, batches, device, quantize, proposals,
                       frozen_norms_from, fault)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _replay(cfg, seed, tau, batches, device, quantize, proposals, frozen_norms_from,
            fault) -> Readings:
    from portbench.refmodel.layers import set_quantizer
    from portbench.refmodel.solver import build_optimizer

    seed = trainer_seed(seed)
    model = build_reference(cfg, seed, tau, device).train()
    set_quantizer(model, quantize)
    if frozen_norms_from is not None:
        calibrate_frozen_norms(model, batch_from_arrays(frozen_norms_from, device).images)
    optimizer = build_optimizer(_double_lr(cfg).solver if fault == "lr_x2" else cfg.solver,
                                model)
    snap = Snapshot(model, optimizer, len(batches))
    snap.start()
    heads = snap.readings.rpn_heads
    hook = model.proposal_generator.rpn_head.register_forward_hook(
        lambda m, i, out: heads.append(tuple([t.detach() for t in x] for x in out)))
    params = [p for _, p in snap.params()]
    gen = torch.Generator(device=device)
    for i, b in enumerate(batches):
        gen.manual_seed(sampling_seed(seed + 1, 0, i))
        optimizer.zero_grad(set_to_none=True)
        if fault == "half_batch":
            b = {k: v[:1] if isinstance(v, np.ndarray) and v.ndim else v for k, v in b.items()}
        b = batch_from_arrays(b, device)
        # proposals that do not cover the batch (a program that left images
        # out) are not followed: the reference takes its own
        props = None
        if proposals is not None and proposals[i][0].shape[0] >= b.images.shape[0]:
            props = tuple(t[:b.images.shape[0]].to(device) for t in proposals[i])
        losses = model(b.images, b.image_sizes, gt=b.gt, sem_seg_gt=b.sem_seg,
                       train=True, generator=gen, proposals=props)
        total = sum(losses.values())
        total.backward()
        with torch.no_grad():
            if fault == "grad_x2":
                for p in params:
                    if p.grad is not None:
                        p.grad.mul_(2)
            before = [p.detach().clone() for p in params] if fault == "negated_update" else None
            optimizer.step()
            if before is not None:
                for p, q in zip(params, before):
                    p.copy_(2 * q - p)
        values = {k: float(v.detach()) for k, v in losses.items()}
        values["total_loss"] = float(total.detach())
        snap.after_step(i, values)
    hook.remove()
    del model, optimizer, params
    return snap.readings


def control_replay(cfg, compute_dtype: str, seed: int, tau: float, batches: List[dict],
                   device, **kw) -> Readings:
    """The control: the reference (``cfg``, f32) put in the program's place
    one precision below the configuration's ``compute_dtype``: fp8 operands
    (e4m3; gradients e5m2) on every tensor the program holds in bf16 for a
    bf16 configuration, bf16 products for an f32 one."""
    if compute_dtype == "float32":
        return replay(at_precision(cfg, "bfloat16"), seed, tau, batches, device, **kw)
    return replay(cfg, seed, tau, batches, device, quantize=fp8_operands, **kw)


def proposals_from_heads(cfg, logits_nchw, deltas_nchw, image_sizes, device):
    """The reference's proposal stage (decode, clip, NMS per level, top-k)
    on given RPN head outputs: (boxes, scores, valid) at training's
    sizes."""
    import types

    from portbench.refmodel.anchors import multilevel_anchors
    from portbench.refmodel.fpn import FPN_STRIDES
    from portbench.refmodel.rpn import RPN

    c = cfg.model.rpn
    b = logits_nchw[0].shape[0]
    logits = [l.to(device).permute(0, 2, 3, 1).reshape(b, -1) for l in logits_nchw]
    deltas = [d.to(device).permute(0, 2, 3, 1).reshape(b, -1, 4) for d in deltas_nchw]
    anchors = multilevel_anchors(
        [l.shape[2:4] for l in logits_nchw], [FPN_STRIDES[n] for n in c.in_features],
        cfg.model.anchors.sizes, cfg.model.anchors.aspect_ratios, cfg.model.anchors.offset,
        device=device)
    stage = types.SimpleNamespace(cfg=c)
    return RPN._predict_proposals(stage, anchors, logits, deltas, image_sizes.to(device),
                                  c.pre_nms_topk_train, c.post_nms_topk_train)


def proposal_gap(prog: tuple, ref: tuple, tol: float = 1e-3) -> float:
    """The share of proposal slots where the program's and the reference's
    proposals differ: in validity, or by more than ``tol`` pixels (1 where
    their shapes differ)."""
    pb, _, pv = (t.to(ref[0].device) for t in prog)
    rb, _, rv = ref
    if pb.shape != rb.shape:
        return 1.0
    differ = (pv != rv) | ((pb - rb).abs().amax(-1) > tol) & rv
    return float(differ.float().mean())


def leaf_part(name: str) -> str:
    """The part of the model a leaf belongs to: its top-level module, with
    the backbone's trunk and FPN, and each of the ROI heads (each stage of
    a cascade) as parts of their own; a box stage's predictor belongs to its
    box head. Alone, the predictor's four leaves make a part whose median
    its two box-regression leaves set, and those swing by several per cent
    between two sound computations: the L1 box loss turns a prediction a
    rounding from its target into a gradient of the other sign, one sample
    among the few foreground ones of a step."""
    import re

    a = name.split(".")
    if a[0] == "backbone" and len(a) > 2:
        return "backbone." + re.sub(r"_(lateral|output)\d+$", "", a[1])
    if a[0] == "roi_heads" and len(a) > 2:
        a[1] = "box_head" if a[1] == "box_predictor" else a[1]
        return ".".join(a[:3] if a[2].isdigit() else a[:2])
    return a[0]


def median_ratio(prog: Dict[str, float], ref: Dict[str, float], keep) -> float:
    """The median over the leaves of ``keep`` of the ratio program /
    reference of their norms."""
    return float(np.median([prog.get(n, 0.0) / ref[n] for n in keep]))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> List[float]:
    """Per leaf of ``keep``: how far the ratio of the two sides' norms lies
    from the median leaf's ratio, as a share of it (a scale common to all
    leaves drops out: ``median_ratio`` holds it); where the program gave
    no leaf a norm, every leaf reads 1."""
    scale = median_ratio(prog, ref, keep)
    if scale <= 0:
        return [1.0] * len(keep)
    return [abs(prog.get(n, 0.0) / ref[n] / scale - 1.0) for n in keep]


def angle_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               keep) -> List[float]:
    """Per leaf of ``keep``: 1 - the cosine between the two sides' tensors
    (1 where the program has none, or a zero one)."""
    out = []
    for n in keep:
        p, r = prog.get(n), ref[n]
        if p is None:
            out.append(1.0)
            continue
        p, r = p.double().flatten(), r.double().flatten()
        denom = float(p.norm() * r.norm())
        out.append(1.0 - float(p @ r) / denom if denom > 0 else 1.0)
    return out


def by_part(values: List[float], keep) -> Dict[str, float]:
    """The median of ``values`` (one per leaf of ``keep``) within each part
    of the model."""
    parts: Dict[str, List[float]] = {}
    for v, n in zip(values, keep):
        parts.setdefault(leaf_part(n), []).append(v)
    return {k: float(np.median(v)) for k, v in parts.items()}


def kept_leaves(ref: Readings) -> List[str]:
    """The leaves the numbers cover: those the reference gives a first
    gradient of at least a thousandth of the median leaf's."""
    median = float(np.median(list(ref.grad_norms.values())))
    return [n for n, g in ref.grad_norms.items() if g >= NOUGHT_SHARE * median]


def rpn_head_gap(prog: List[tuple], ref: List[tuple]) -> float:
    """In the first step, where both sides hold the same weights: the
    larger, over the objectness logits and the anchor deltas, of the norm of
    the two sides' difference over the reference's norm, all levels together
    (1 where the program gave no step or other shapes). Later steps are left
    out: at seeded weights the trunk's forward turns the last bits of the
    warm-up's first updates into gaps of a fifth."""
    if not prog or not ref:
        return 1.0
    worst = 0.0
    for p_levels, r_levels in zip(prog[0], ref[0]):
        diff = ref_sq = 0.0
        for p, r in zip(p_levels, r_levels):
            if p.shape != r.shape:
                return 1.0
            r = r.double()
            diff += float(((p.to(r.device).double() - r) ** 2).sum())
            ref_sq += float((r ** 2).sum())
        worst = max(worst, math.sqrt(diff / ref_sq) if ref_sq > 0 else float(diff > 0))
    return worst


def update_ulps(ref: Readings, keep) -> float:
    """The median over the leaves of ``keep`` of the reference's change
    after the steps, in units of the f32 rounding of the leaf's weights
    (norm of the change over 2^-23 times the norm of the start): how far
    above rounding the update numbers read (for a look)."""
    eps = 2.0 ** -23
    return float(np.median([ref.update_norms[n] / (eps * ref.init_norms[n]) for n in keep
                            if ref.init_norms.get(n, 0.0) > 0]))


def compare(prog: Readings, ref: Readings) -> Dict[str, float]:
    """The numbers compared (see the module doc) of ``prog`` against
    ``ref``, and a few more for a look (``*_median``: over all leaves;
    ``*_worst``: the worst leaf; ``*_part``: each part's)."""
    loss_gap = max(abs(p["total_loss"] - r["total_loss"]) / abs(r["total_loss"])
                   for p, r in zip(prog.losses, ref.losses))
    term_gap = max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-3 * abs(r["total_loss"]))
                   for p, r in zip(prog.losses, ref.losses) for k in r)
    init_gap = max(abs(prog.init_norms.get(n, 0.0) - r) / r if r > 0 else
                   float(prog.init_norms.get(n, 0.0) != 0.0)
                   for n, r in ref.init_norms.items())
    keep = kept_leaves(ref)
    moved = [n for n in keep if ref.update_norms.get(n, 0.0) > 0]
    out = {"init_gap": init_gap, "loss_gap": loss_gap, "loss_term_gap": term_gap,
           "rpn_head_gap": rpn_head_gap(prog.rpn_heads, ref.rpn_heads),
           "grad_scale": abs(median_ratio(prog.grad_norms, ref.grad_norms, keep) - 1.0),
           "update_scale": abs(median_ratio(prog.update_norms, ref.update_norms, moved) - 1.0),
           "update_ulps": update_ulps(ref, moved), "leaves": float(len(keep))}
    for name, values, leaves in (
            ("grad_gap", leaf_gaps(prog.grad_norms, ref.grad_norms, keep), keep),
            ("update_gap", leaf_gaps(prog.update_norms, ref.update_norms, moved), moved),
            ("grad_angle", angle_gaps(prog.grads, ref.grads, keep), keep),
            ("update_angle", angle_gaps(prog.updates, ref.updates, moved), moved)):
        parts = by_part(values, leaves)
        out[name] = max(parts.values())
        out[name + "_median"] = float(np.median(values))
        out[name + "_worst"] = max(values)
        out.update({f"{name}_part.{k}": v for k, v in parts.items()})
    return out


def compare_both(prog: Readings, ref: Readings, ref16: Readings) -> Dict[str, float]:
    """``compare`` against the f32 reference, and with ``_bf16`` against the
    reference at the configuration's own compute dtype (the f32 reference
    itself where that is f32)."""
    numbers = compare(prog, ref)
    numbers.update({k + "_bf16": v for k, v in
                    (numbers if ref16 is ref else compare(prog, ref16)).items()})
    return numbers


def worst_leaves(prog: Readings, ref: Readings, n: int = 5,
                 key: str = "grad_norms") -> List[tuple]:
    """The ``n`` leaves with the largest gap of ``key`` (for a look)."""
    p, r = getattr(prog, key), getattr(ref, key)
    keep = [k for k in kept_leaves(ref) if r.get(k, 0.0) > 0]
    gaps = leaf_gaps(p, r, keep)
    return sorted(((g, k, p.get(k, 0.0), r[k]) for g, k in zip(gaps, keep)),
                  reverse=True)[:n]


def finite(readings: Readings) -> bool:
    values = [v for step in readings.losses for v in step.values()]
    values += list(readings.grad_norms.values()) + list(readings.update_norms.values())
    return all(math.isfinite(v) for v in values)
