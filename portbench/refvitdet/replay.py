"""The ViTDet cell's replay of the program's first steps on the reference,
and the numbers that decide ``correct``.

``replay`` builds the reference (``model.ViTDetRCNN``) from the
configuration and the seed as the port's trainer builds its own and follows
the program's first steps on its kept batches: each step's generator seeded
as the trainer seeds its own, so the stochastic-depth masks and the RPN's
anchor sampling are the program's draws, and the ROI heads sampling from
the program's proposals. It runs in f32 with TF32 off, or at the
configuration's compute dtype, each block recomputed in the backward (to
hold one block's activations at a time). ``control_replay`` is the control (the f32
reference with fp8 operands, e4m3, and gradients, e5m2, on every tensor the
program holds in bf16); a ``fault`` of ``FAULTS`` plants a fault.

The numbers are ``portbench.reference_train``'s (its module doc), taken by
this model's parts (``leaf_part``). The first gradient is read from AdamW's
first moment after one step, ``exp_avg / (1 - beta1)`` (its decay is
decoupled, so nothing else is in it); the readings are
``reference_train.Readings``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench import counts, reference_train as rt

FAULTS = {
    "half_batch": "half of the batch left out, the mean taken over the rest",
    "lr_x2": "the learning rate doubled",
    "negated_update": "every update applied with its sign flipped",
    "no_rel_pos": "the relative-position bias left out of every block",
    "global_windowed": "the global blocks attend inside windows",
}


class Snapshot(rt.Snapshot):
    """``reference_train.Snapshot`` for AdamW: the first gradient is the
    first moment after one step over (1 - beta1)."""

    def after_step(self, i: int, losses: Dict[str, float]) -> None:
        if i == 0:
            group = self.optimizer.param_groups[0]
            b1 = group.get("betas", getattr(self.optimizer, "betas", None))[0]
            for n, p in self.params():
                m = self.optimizer.state.get(p, {}).get("exp_avg")
                if m is None:                     # no gradient, or no step taken
                    continue
                grad = m.double() / (1 - b1)
                self.readings.grad_norms[n] = float(grad.norm())
                self.readings.grads[n] = grad.float().cpu()
        # the base class finds no momentum to read, and keeps the losses and
        # the change after the steps
        super().after_step(i, losses)


def load_config(config_file: str, overrides: List[str]):
    """The configuration file and the run's overrides, read by the
    reference's own loader, the compute in f32."""
    from portbench.refvitdet.config import load_config as load

    flat, _ = rt.read_config_file(config_file)
    return load(flat + list(overrides) + ["model.compute_dtype=float32"])


def input_hw(cfg) -> tuple:
    """The (H, W) the model is built for: the first pad bucket."""
    return tuple(cfg.input.pad_buckets[0])


def build(cfg, seed: int, tau: float, device, state=None) -> torch.nn.Module:
    """The reference model on ``device``: seeded (and its classifiers
    scaled by ``tau``), or holding ``state`` (a state dict of one built so)."""
    from portbench.refvitdet.init import seeded_init
    from portbench.refvitdet.model import ViTDetRCNN

    model = ViTDetRCNN(cfg.model, input_hw(cfg))
    if state is None:
        seeded_init(model, seed)
        model = model.to(device)
        rt.scale_cls_score(model, tau)
    else:
        model = model.to(device)
        model.load_state_dict(state)
    return model


def initial_state(cfg, seed: int, tau: float, device) -> Dict[str, torch.Tensor]:
    """The state every replay of one run starts from (built once)."""
    model = build(cfg, rt.trainer_seed(seed), tau, device)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def arrays(b: dict) -> dict:
    """One batch of the loader's arrays with a stuff map: instance data
    (``coco_2017_train``) comes without one, and the batch readers of
    ``reference_train`` and ``drivers/train.py`` take it (all ignored)."""
    if "sem_seg" in b:
        return b
    return dict(b, sem_seg=np.full(np.asarray(b["image"]).shape[:3], 255, np.int32))


def plant(model, fault: Optional[str]) -> None:
    for blk in model.backbone.net.blocks:
        blk.attn.rel_pos_off = fault == "no_rel_pos"
        blk.global_windowed = fault == "global_windowed"


def replay(cfg, seed: int, tau: float, batches: List[dict], device,
           quantize: Optional[Callable] = None, proposals: Optional[List[tuple]] = None,
           fault: Optional[str] = None, state=None) -> rt.Readings:
    """The reference's readings over ``batches`` (the loader's arrays of the
    program's first steps, one step each); see the module doc."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"no fault {fault!r}")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _replay(cfg, seed, tau, batches, device, quantize, proposals, fault, state)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _replay(cfg, seed, tau, batches, device, quantize, proposals, fault, state):
    from portbench.refvitdet.model import set_quantizer
    from portbench.refvitdet.solver import build_optimizer

    seed = rt.trainer_seed(seed)
    model = build(cfg, seed, tau, device, state).train()
    model.backbone.net.checkpoint = True
    set_quantizer(model, quantize)
    plant(model, fault)
    solver = cfg.solver
    if fault == "lr_x2":
        solver = dataclasses.replace(solver, base_lr=2 * solver.base_lr)
    optimizer = build_optimizer(solver, model)
    snap = Snapshot(model, optimizer, len(batches))
    snap.start()
    heads = snap.readings.rpn_heads
    hook = model.proposal_generator.rpn_head.register_forward_hook(
        lambda m, i, out: heads.append(tuple([t.detach() for t in x] for x in out)))
    params = [p for _, p in snap.params()]
    gen = torch.Generator(device=device)
    for i, b in enumerate(batches):
        gen.manual_seed(rt.sampling_seed(seed + 1, 0, i))
        optimizer.zero_grad(set_to_none=True)
        if fault == "half_batch":
            b = {k: v[:len(v) // 2] if isinstance(v, np.ndarray) and v.ndim else v
                 for k, v in b.items()}
        b = rt.batch_from_arrays(arrays(b), device)
        n = b.images.shape[0]
        props = None
        if proposals is not None and proposals[i][0].shape[0] >= n:
            props = tuple(t[:n].to(device) for t in proposals[i])
        losses = model(b.images, b.image_sizes, gt=b.gt, train=True, generator=gen,
                       proposals=props)
        total = sum(losses.values())
        total.backward()
        with torch.no_grad():
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


def control_replay(cfg, seed: int, tau: float, batches: List[dict], device, **kw):
    """The control: the f32 reference with fp8 operands on every tensor the
    program holds in bf16, in the program's place."""
    return replay(cfg, seed, tau, batches, device, quantize=rt.fp8_operands, **kw)


# -- the numbers --------------------------------------------------------------

def leaf_part(name: str, global_blocks: Sequence[int]) -> str:
    """The part of the model a leaf belongs to: the patch conv and
    ``pos_embed``; the windowed blocks; the global blocks; the relative
    position tables; the pyramid; the RPN; each box stage with its
    predictor; the mask head."""
    a = name.split(".")
    if a[0] == "backbone":
        if a[1] == "net":
            if a[2] == "blocks":
                if a[-1] in ("rel_pos_h", "rel_pos_w"):
                    return "backbone.rel_pos"
                return "backbone.blocks." + ("global" if int(a[3]) in global_blocks
                                             else "window")
            return "backbone.patch"
        return "backbone.pyramid"
    if a[0] == "roi_heads" and len(a) > 2:
        a[1] = "box_head" if a[1] == "box_predictor" else a[1]
        return ".".join(a[:3] if a[2].isdigit() else a[:2])
    return a[0]


def compare(prog: rt.Readings, ref: rt.Readings, global_blocks) -> Dict[str, float]:
    """``reference_train.compare`` by this model's parts."""
    loss_gap = max(abs(p["total_loss"] - r["total_loss"]) / abs(r["total_loss"])
                   for p, r in zip(prog.losses, ref.losses))
    init_gap = max(abs(prog.init_norms.get(n, 0.0) - r) / r if r > 0 else
                   float(prog.init_norms.get(n, 0.0) != 0.0)
                   for n, r in ref.init_norms.items())
    keep = rt.kept_leaves(ref)
    moved = [n for n in keep if ref.update_norms.get(n, 0.0) > 0]
    out = {"init_gap": init_gap, "loss_gap": loss_gap,
           "rpn_head_gap": rt.rpn_head_gap(prog.rpn_heads, ref.rpn_heads),
           "grad_scale": abs(rt.median_ratio(prog.grad_norms, ref.grad_norms, keep) - 1.0),
           "update_scale": abs(rt.median_ratio(prog.update_norms, ref.update_norms, moved)
                               - 1.0),
           "update_ulps": rt.update_ulps(ref, moved), "leaves": float(len(keep))}
    for name, values, leaves in (
            ("grad_gap", rt.leaf_gaps(prog.grad_norms, ref.grad_norms, keep), keep),
            ("update_gap", rt.leaf_gaps(prog.update_norms, ref.update_norms, moved), moved),
            ("grad_angle", rt.angle_gaps(prog.grads, ref.grads, keep), keep),
            ("update_angle", rt.angle_gaps(prog.updates, ref.updates, moved), moved)):
        parts: Dict[str, List[float]] = {}
        for v, n in zip(values, leaves):
            parts.setdefault(leaf_part(n, global_blocks), []).append(v)
        medians = {k: float(np.median(v)) for k, v in parts.items()}
        out[name] = max(medians.values())
        out[name + "_median"] = float(np.median(values))
        out.update({f"{name}_part.{k}": v for k, v in medians.items()})
    return out


def compare_both(prog, ref, ref16, global_blocks) -> Dict[str, float]:
    """``compare`` against the f32 reference, and with ``_bf16`` against the
    reference at the configuration's own compute dtype."""
    numbers = compare(prog, ref, global_blocks)
    numbers.update({k + "_bf16": v for k, v in
                    (numbers if ref16 is ref else compare(prog, ref16, global_blocks)).items()})
    return numbers


def step_flops(cfg, seed: int, tau: float, batch: dict, steps: int, device,
               state=None) -> float:
    """FLOPs of ``steps`` training steps (forward and backward), counted on
    the reference at the configuration's compute dtype on the first image
    of ``batch`` and scaled by the step's images: every product of the
    model (the trunk, the RPN's convs over each image, 512 sampled ROIs and
    at most 128 mask ROIs an image) grows with the images linearly, and one
    image's count holds one image's activations."""
    one = {k: v[:1] if isinstance(v, np.ndarray) and v.ndim else v for k, v in batch.items()}
    model = build(cfg, rt.trainer_seed(seed), tau, device, state).train()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    b = rt.batch_from_arrays(arrays(one), device)

    def step():
        model.zero_grad(set_to_none=True)
        losses = model(b.images, b.image_sizes, gt=b.gt, train=True, generator=gen)
        sum(losses.values()).backward()

    flops = counts.counted_flops(step)
    del model
    return flops * len(batch["image"]) * steps
