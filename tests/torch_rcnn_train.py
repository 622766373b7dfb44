"""The training forward of the R-CNN meta-architectures of u2seg_torch vs the
JAX package, on the CPU: the cases and checks that
``test_torch_rcnn_losses.py`` (Mask + Keypoint R-CNN with a 2-conv GN box
head, ProposalNetwork, SemanticSegmentor) and ``test_torch_cascade_losses.py``
(Cascade Mask R-CNN) run, one JAX compile per case and check kind.

Both sides take one numpy batch (b=2, 64x64, 3 gt boxes with 32x32 uniform
float mask patches and 17 keypoints each, some outside their box or not
visible) and one variable tree drawn from numpy
(``torch_zoo_parity.random_variables``). Sampling is RNG-free as in
``test_torch_train_step.py``: the RPN and ROI batch sizes take every
candidate, and the losses are sums over slots, so the two frameworks'
different random draws only reorder the slots. The keypoint and mask ROIs
are all the wanted foreground ones (fewer than the capacity of 128), so
their order drops out too. The trunk is FrozenBN and the FPN has no norm:
with no train-mode BatchNorm to amplify f32 noise, whole-model gradients
are comparable almost as tightly as the heads'.

Tolerances: every loss rtol 1e-4; the heads on the SAME numpy features (RPN
and ROI heads, poolers and losses): every gradient w.r.t. the head
parameters and the feature maps <= 1e-4 * max|grad|; the whole model, as in
``test_torch_train_step.py``: every gradient tensor <= 5e-2 * max|grad| of
that tensor and at least 80% of them <= 1e-3 (measured: worst 2.2e-3, in
the stem, where every ReLU whose input lies within f32 noise of 0 has
switched on one side only); JAX's stop-gradient zeros where the port has no
gradient (the frozen norms). The keypoint head's ``score_lowres.bias`` has
a gradient of exactly 0 in exact arithmetic (the heatmap softmax does not
see a shift of all its bins): both sides must keep it at rounding noise,
<= 1e-4 * max|grad| of ``score_lowres.weight``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_zoo_parity import jnp_tree, port_from, random_variables, tiny
from u2seg_tpu.config import config as jconfig
from u2seg_tpu.models.build import build_model as jbuild
from u2seg_tpu.structures.instances import GtInstances as JGt
from u2seg_torch import config as tconfig
from u2seg_torch.models.build import build_model
from u2seg_torch.structures.instances import GtInstances
from u2seg_torch.weights import from_jax

torch.set_num_threads(1)

RNG_FREE = {"rpn.pre_nms_topk_train": 64, "rpn.post_nms_topk_train": 64,
            "rpn.batch_size_per_image": 2048, "rpn.positive_fraction": 0.5,
            "roi_heads.batch_size_per_image": 256, "roi_heads.positive_fraction": 0.5,
            "resnet.norm": "FrozenBN", "fpn.norm": ""}
CASES = {
    "mask_keypoint": ("GeneralizedRCNN", {
        "roi_heads.name": "StandardROIHeads", "keypoint_on": True,
        "roi_heads.box_head.num_conv": 2, "roi_heads.box_head.num_fc": 1,
        "roi_heads.box_head.norm": "GN"}),
    "cascade_mask": ("GeneralizedRCNN", {"roi_heads.name": "CascadeROIHeads"}),
    "rpn": ("ProposalNetwork", {}),
    "sem": ("SemanticSegmentor", {}),
}
KEYS = {
    "mask_keypoint": ["loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg",
                      "loss_mask", "loss_keypoint"],
    "cascade_mask": (["loss_rpn_cls", "loss_rpn_loc", "loss_mask"]
                     + [f"loss_{k}_stage{i}" for i in range(3) for k in ("cls", "box_reg")]),
    "rpn": ["loss_rpn_cls", "loss_rpn_loc"],
    "sem": ["loss_sem_seg"],
}


def batch():
    rng = np.random.RandomState(2)
    b, g, n_kp, hw = 2, 3, 17, 64
    images = (rng.rand(b, hw, hw, 3) * 255).astype(np.float32)
    xy = rng.rand(b, g, 2) * hw / 2
    wh = rng.rand(b, g, 2) * hw / 3 + 8
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    # keypoints over the box and a margin around it: some fall outside
    u = rng.uniform(-0.15, 1.15, (b, g, n_kp, 2))
    kxy = boxes[..., None, :2] + u * (boxes[..., None, 2:] - boxes[..., None, :2])
    vis = rng.randint(0, 3, (b, g, n_kp, 1)).astype(np.float32)
    return dict(
        images=images, sizes=np.array([[hw, hw]] * b, np.int32), boxes=boxes,
        classes=rng.randint(0, 7, (b, g)).astype(np.int32),
        valid=np.ones((b, g), bool),
        masks=rng.rand(b, g, 32, 32).astype(np.float32),
        keypoints=np.concatenate([kxy, vis], -1).astype(np.float32),
        sem=rng.randint(0, 5, (b, hw, hw)).astype(np.int32))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


SHIFT_INVARIANT = "roi_heads.keypoint_head.score_lowres.bias"


def _gradient_errors(got, ref, names):
    """{name: error of max|grad|}; the shift-invariant bias held apart."""
    errs = {}
    for k in names:
        if k == SHIFT_INVARIANT:
            scale = float(ref[k.replace(".bias", ".weight")].abs().max())
            assert float(got[k].abs().max()) <= 1e-4 * scale
            assert float(ref[k].abs().max()) <= 1e-4 * scale
            continue
        assert float(ref[k].abs().max()) > 0, f"{k}: zero reference gradient"
        errs[k] = _rel(got[k], ref[k])
    return errs


def _jax_losses(jm, meta, bt, v, features=None):
    """The JAX loss dict (whole model, or the heads on ``features``) and the
    gradients w.r.t. (params, features)."""
    gt = JGt(*(jnp.asarray(bt[k]) for k in ("boxes", "classes", "valid", "masks",
                                             "keypoints")))
    images, sizes = jnp.asarray(bt["images"]), jnp.asarray(bt["sizes"])

    def heads(m, f):
        rpn = m.proposal_generator(f, sizes, gt=gt, train=True)
        roi = m.roi_heads(f, rpn.proposal_boxes, rpn.proposal_scores,
                          rpn.proposal_valid, sizes, gt=gt, train=True)
        return {**rpn.losses, **roi}

    def loss_fn(p, f):
        var = {"params": p, "batch_stats": v.get("batch_stats", {})}
        rngs = {"sampling": jax.random.PRNGKey(0)}
        if f is not None:
            losses = jm.apply(var, f, method=heads, rngs=rngs)
        elif meta == "SemanticSegmentor":
            losses = jm.apply(var, images, sizes, sem_seg_gt=jnp.asarray(bt["sem"]),
                              train=True, rngs=rngs)
        else:
            losses = jm.apply(var, images, sizes, gt=gt, train=True, rngs=rngs)
        return sum(losses.values()), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
        jnp_tree(v["params"]), features)
    return jax.tree_util.tree_map(np.asarray, (losses, grads))


@functools.lru_cache(maxsize=None)
def train_run(case):
    """One case: the JAX loss dict and gradients, the port's after one
    backward, on the same batch and numbers (once per process)."""
    meta, over = CASES[case]
    over = dict(RNG_FREE, **over)
    cfg_j, cfg_t = tiny(jconfig.Config(), meta, **over), tiny(tconfig.Config(), meta, **over)
    bt = batch()
    jm = jbuild(cfg_j)
    v = random_variables(jm, 7, jnp.asarray(bt["images"]), jnp.asarray(bt["sizes"]),
                         train=False)
    ref_losses, (ref_grads, _) = _jax_losses(jm, meta, bt, v)

    model = port_from(v, build_model(cfg_t, device="cpu")).train()
    images, sizes = torch.from_numpy(bt["images"]), torch.from_numpy(bt["sizes"])
    gt = GtInstances(*(torch.from_numpy(bt[k]) for k in ("boxes", "classes", "valid",
                                                          "masks", "keypoints")))
    if meta == "SemanticSegmentor":
        losses = model(images, sizes, sem_seg_gt=torch.from_numpy(bt["sem"]), train=True)
    else:
        losses = model(images, sizes, gt=gt, train=True,
                       generator=torch.Generator().manual_seed(0))
    sum(losses.values()).backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    return dict(case=case, meta=meta, jm=jm, v=v, bt=bt, gt=gt, model=model,
                ref_losses=ref_losses, losses={k: float(x.detach()) for k, x in losses.items()},
                ref_grads=from_jax(ref_grads, v.get("batch_stats", {})), grads=grads)



def check_losses(run):
    keys = KEYS[run["case"]]
    assert sorted(run["losses"]) == sorted(run["ref_losses"]) == sorted(keys)
    for k in keys:
        assert np.isfinite(run["losses"][k]) and run["losses"][k] > 0, k
        np.testing.assert_allclose(run["losses"][k], float(run["ref_losses"][k]),
                                   rtol=1e-4, err_msg=k)


def check_whole_model_gradients(run):
    ref, got = run["ref_grads"], run["grads"]
    names = [k for k, _ in run["model"].named_parameters()]
    frozen = [k for k in names if k not in got]
    assert frozen == [k for k in names if "bottom_up" in k and ".norm." in k]
    for k in frozen:
        assert float(ref[k].abs().max()) == 0, f"{k}: the port has no gradient"
    errs = _gradient_errors(got, ref, [k for k in names if k in got])
    worst = max(errs, key=errs.get)
    tight = sum(e <= 1e-3 for e in errs.values()) / len(errs)
    print(f"worst whole-model gradient error {errs[worst]:.2e} of max|grad| ({worst}); "
          f"{tight:.0%} of {len(errs)} tensors within 1e-3")
    assert errs[worst] <= 5e-2, (worst, errs[worst])
    assert tight >= 0.8, tight


def check_head_gradients(run):
    rng = np.random.RandomState(5)
    feats = {f"p{l}": rng.randn(2, 64 >> l, 64 >> l, 32).astype(np.float32)
             for l in range(2, 7)}
    ref_losses, (gp, gf) = _jax_losses(run["jm"], run["meta"], run["bt"], run["v"],
                                       {k: jnp.asarray(x) for k, x in feats.items()})
    model = run["model"]
    model.zero_grad(set_to_none=True)
    tf = {k: torch.from_numpy(x.copy()).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_() for k, x in feats.items()}
    bt = run["bt"]
    losses = model.losses_from_features(tf, torch.from_numpy(bt["sizes"]), run["gt"],
                                        torch.Generator().manual_seed(0))
    for k, x in losses.items():
        np.testing.assert_allclose(float(x.detach()), float(ref_losses[k]), rtol=1e-4, err_msg=k)
    sum(losses.values()).backward()
    for k, x in tf.items():
        err = _rel(x.grad.permute(0, 2, 3, 1).numpy(), gf[k])
        assert err <= 1e-4, f"d/d{k}: {err:.2e} of max|grad|"
    ref = from_jax(gp, run["v"].get("batch_stats", {}))
    got = {k: p.grad for k, p in model.named_parameters() if not k.startswith("backbone.")}
    assert all(p.grad is None for k, p in model.named_parameters() if k.startswith("backbone."))
    errs = _gradient_errors(got, ref, sorted(got))
    assert len(errs) >= 10
    for k, err in errs.items():
        assert err <= 1e-4, f"{k}: {err:.2e} of max|grad|"
