"""The u2seg_torch training step as a whole vs the JAX package, on the CPU.

A seeded port model at a tiny config (bottleneck trunk of 8 blocks, narrow
widths, 7 classes, 3-stage cascade, masks, GN sem-seg head, norm "BN", f32,
``pooler_impl="gather"`` on both sides) is converted with the JAX package's
``convert_d2_panoptic_fpn``. Both sides take the same numpy batch (b=2,
64x64, 3 gt boxes with 32x32 mask patches) through three training steps:
``jax.value_and_grad`` of ``PanopticFPN.apply(..., train=True)`` + ``optax``
from the JAX ``build_optimizer`` against the port's ``make_train_step``.

RNG-free sampling. The two frameworks draw different random numbers, so
``batch_size_per_image`` and ``positive_fraction`` of the RPN and the ROI
heads are chosen so that EVERY candidate is taken (all 1023 anchors of a
64x64 image; all 64 proposals + 3 gt boxes, at most 128 of them foreground).
The losses are sums over the slots, so the slot order, which the random keys
do decide, drops out. The mask patches are uniform floats, not 0/1: resampled
0/1 patches land on the 0.5 target threshold exactly, where the last f32 bit
decides. flax's SyncBN needs a bound mesh axis; on one device it is BN, so
both configs say "BN".

What limits the whole-model gradient comparison. On the CPU the JAX
package's BatchNorm reduces its batch moments about ten times less exactly
than the port's (measured against float64: 1.2e-6 vs 1.2e-7 of max|y| for
the stem), train-mode BN amplifies that from layer to layer (features agree
to ~5e-5 after 8 blocks, ~5e-4 after R50's 16: hence the 8-block trunk),
and a ReLU whose input is within that noise of 0 switches on one side only,
which moves a gradient by percents of a small tensor. So:

- the 10 losses: rtol 1e-4 at steps 0 and 1 (measured <= 5e-6); 2e-3 at
  step 2, after two real updates along slightly different gradients;
- BN running statistics after each step: rtol 1e-3, atol 1e-4 * max;
- heads alone (sem-seg head, RPN, cascade + mask heads, poolers and all
  losses) on the SAME numpy features, where there is no trunk to amplify
  anything: every gradient w.r.t. the head parameters and w.r.t. the five
  feature maps <= 1e-4 * max|grad| (measured 1.2e-6);
- whole model: every gradient tensor <= 5e-2 * max|grad| (measured 9.8e-3,
  in the mask head, whose gradients are ~1e-5), and at least 80% of the
  tensors <= 1e-3 * max|grad| (measured 94%);
- the optimizer on the real model: the JAX gradients of the three steps,
  mapped through ``weights.from_jax``, are fed to the port's optimizer, and
  the parameter change after 3 steps is held to optax's at 1e-3 *
  max|change| per tensor (measured 2.2e-4: one f32 ulp of a parameter
  against its small change); the parameters of the port's own three steps
  are held to the JAX run at 0.1 * max|change| (measured 4.4e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from u2seg_tpu.config import config as jconfig
from u2seg_tpu.config import testing as jtesting
from u2seg_tpu.engine.checkpoint import convert_d2_panoptic_fpn
from u2seg_tpu.models.panoptic_fpn import PanopticFPN as JPanopticFPN
from u2seg_tpu.solver import build_optimizer as jbuild_optimizer
from u2seg_torch import config as tconfig
from u2seg_torch import testing as ttesting
from u2seg_torch.engine.trainer import make_train_step
from u2seg_torch.models.build import build_model
from u2seg_torch.solver import build_optimizer
from u2seg_torch.weights import from_jax

torch.set_num_threads(1)
LOSS_KEYS = (["loss_sem_seg", "loss_rpn_cls", "loss_rpn_loc", "loss_mask"]
             + [f"loss_{k}_stage{i}" for i in range(3) for k in ("cls", "box_reg")])
STEPS = 3


def tiny(cfg):
    m = cfg.model
    m.compute_dtype = "float32"
    m.resnet.norm = "BN"
    m.fpn.norm = "BN"
    m.resnet.depth = 18             # (2, 2, 2, 2) bottleneck blocks
    m.resnet.width_per_group = 8
    m.resnet.stem_out_channels = 16
    m.resnet.res2_out_channels = 32
    m.fpn.out_channels = 32
    m.roi_heads.num_classes = 7
    m.roi_heads.box_head.fc_dim = 64
    m.roi_heads.mask_head.conv_dim = 32
    m.roi_heads.pooler_impl = "gather"
    m.sem_seg_head.conv_dim = 32
    m.sem_seg_head.num_classes = 5
    # RNG-free sampling: every candidate is taken (see the module doc)
    m.rpn.pre_nms_topk_train = 64
    m.rpn.post_nms_topk_train = 64
    m.rpn.batch_size_per_image = 2048
    m.rpn.positive_fraction = 0.5
    m.roi_heads.batch_size_per_image = 256
    m.roi_heads.positive_fraction = 0.5
    cfg.solver.warmup_iters = 2
    return cfg


def randomize(model, rng):
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith(("running_mean", ".bias")):
                v.copy_(torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.1))
            elif k.endswith(("running_var", "norm.weight")):
                v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
    return model


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


@pytest.fixture(scope="module")
def setup():
    cfg_t, cfg_j = tiny(tconfig.Config()), tiny(jconfig.Config())
    model = randomize(build_model(cfg_t, device="cpu"), np.random.RandomState(0))
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    params, stats = convert_d2_panoptic_fpn({k: v.numpy() for k, v in sd0.items()})

    jb = jtesting.tiny_batch(np.random.RandomState(2), b=2)
    tb = ttesting.tiny_batch(np.random.RandomState(2), b=2)
    np.testing.assert_array_equal(tb.images.numpy(), np.asarray(jb.images))
    np.testing.assert_array_equal(tb.gt.boxes.numpy(), np.asarray(jb.gt.boxes))
    np.testing.assert_array_equal(tb.gt.classes.numpy(), np.asarray(jb.gt.classes))
    np.testing.assert_array_equal(tb.gt.masks.numpy(), np.asarray(jb.gt.masks))
    np.testing.assert_array_equal(tb.sem_seg.numpy(), np.asarray(jb.sem_seg))
    soft = np.random.RandomState(99).rand(*tb.gt.masks.shape).astype(np.float32)
    tb.gt.masks = torch.from_numpy(soft.copy())
    jb = dataclasses.replace(jb, gt=dataclasses.replace(jb.gt, masks=jnp.array(soft)))
    return dict(cfg_t=cfg_t, cfg_j=cfg_j, model=model, sd0=sd0, params=params,
                stats=stats, jb=jb, tb=tb)


@pytest.fixture(scope="module")
def runs(setup):
    cfg_t, cfg_j, model = setup["cfg_t"], setup["cfg_j"], setup["model"]
    jb, tb = setup["jb"], setup["tb"]

    # ---- JAX: three steps of value_and_grad + optax ----
    jm = JPanopticFPN(cfg_j.model)
    tx = jbuild_optimizer(cfg_j.solver)

    def loss_fn(p, s, key):
        losses, new = jm.apply(
            {"params": p, "batch_stats": s}, jb.images, jb.image_sizes, gt=jb.gt,
            sem_seg_gt=jb.sem_seg, train=True, rngs={"sampling": key},
            mutable=["batch_stats"])
        return sum(losses.values()), (losses, new["batch_stats"])

    @jax.jit
    def jstep(p, s, opt, key):
        (total, (losses, new_s)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p, s, key)
        updates, opt = tx.update(grads, opt, p)
        return optax.apply_updates(p, updates), new_s, opt, losses, total, grads

    p, s, opt = setup["params"], setup["stats"], tx.init(setup["params"])
    ref = []
    for i in range(STEPS):
        p, s, opt, losses, total, grads = jstep(p, s, opt, jax.random.PRNGKey(i))
        ref.append(dict(losses=_np_tree(losses), total=float(total),
                        grads=_np_tree(grads), stats=_np_tree(s)))
    ref_final = from_jax(_np_tree(p), _np_tree(s))

    # ---- the port: three steps of make_train_step ----
    model.load_state_dict(setup["sd0"])
    model.train()
    optimizer = build_optimizer(cfg_t.solver, model)
    step = make_train_step(model, optimizer)
    gen = torch.Generator().manual_seed(0)
    raw_grads = []                  # as backward left them, before the clip
    clip = optimizer.clip_gradients

    def capture_then_clip():
        raw_grads.append({k: v.grad.clone() for k, v in model.named_parameters()
                          if v.grad is not None})
        clip()

    optimizer.clip_gradients = capture_then_clip
    got = []
    for i in range(STEPS):
        metrics = step(tb, gen)
        got.append(dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads=raw_grads[i],
            stats={k: v.clone() for k, v in model.state_dict().items()
                   if "running_" in k}))
    final = {k: v.clone() for k, v in model.state_dict().items()}
    return dict(ref=ref, got=got, ref_final=ref_final, final=final)


@pytest.mark.parametrize("i", range(STEPS))
def test_losses_match_jax(runs, i):
    ref, got = runs["ref"][i], runs["got"][i]["metrics"]
    assert sorted(got) == sorted(LOSS_KEYS + ["total_loss"])
    assert sorted(ref["losses"]) == sorted(LOSS_KEYS)
    rtol = 1e-4 if i < 2 else 2e-3
    for k in LOSS_KEYS:
        assert np.isfinite(got[k]) and got[k] > 0, k
        np.testing.assert_allclose(got[k], float(ref["losses"][k]), rtol=rtol,
                                   err_msg=f"step {i} {k}")
    np.testing.assert_allclose(got["total_loss"], ref["total"], rtol=rtol)


def test_whole_model_gradients_match_jax(setup, runs):
    ref = from_jax(runs["ref"][0]["grads"], setup["stats"])
    got = runs["got"][0]["grads"]
    names = [k for k, _ in setup["model"].named_parameters()]
    assert sorted(got) == sorted(names)            # every parameter has one
    errs = {}
    for k in names:
        assert float(ref[k].abs().max()) > 0, f"{k}: zero reference gradient"
        errs[k] = _rel_err(got[k], ref[k])
    worst = max(errs, key=errs.get)
    tight = sum(e <= 1e-3 for e in errs.values()) / len(errs)
    print(f"worst gradient error {errs[worst]:.2e} of max|grad| ({worst}); "
          f"{tight:.0%} of {len(errs)} tensors within 1e-3")
    assert errs[worst] <= 5e-2, (worst, errs[worst])
    assert tight >= 0.8, tight


@pytest.mark.parametrize("i", range(STEPS))
def test_bn_running_stats_match_jax(setup, runs, i):
    ref = from_jax(runs["ref"][0]["grads"], runs["ref"][i]["stats"])
    got = runs["got"][i]["stats"]
    assert len(got) == 2 * 37                      # 29 trunk + 8 FPN norms
    for k, v in got.items():
        r = ref[k].numpy()
        np.testing.assert_allclose(v.numpy(), r, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(r).max()), err_msg=k)
        assert not torch.equal(v, setup["sd0"][k]), f"{k} did not move"


def test_parameters_after_three_steps_match_jax(setup, runs):
    worst = 0.0
    for k, _ in setup["model"].named_parameters():
        d_ref = (runs["ref_final"][k] - setup["sd0"][k]).numpy()
        d_got = (runs["final"][k] - setup["sd0"][k]).numpy()
        assert float(np.abs(d_ref).max()) > 0, f"{k} did not move"
        err = _rel_err(d_got, d_ref)
        worst = max(worst, err)
        assert err <= 0.1, f"{k}: {err:.2e} of max|change|"
    print(f"worst parameter-change error {worst:.2e} of max|change|")


def test_optimizer_on_the_model_matches_optax(setup, runs):
    """The port's optimizer fed the JAX gradients of the three steps: param
    groups, clipping, decay, momentum and schedule over the real model."""
    model = build_model(setup["cfg_t"], device="cpu")
    model.load_state_dict(setup["sd0"])
    optimizer = build_optimizer(setup["cfg_t"].solver, model.train())
    for i in range(STEPS):
        grads = from_jax(runs["ref"][i]["grads"], setup["stats"])
        for k, v in model.named_parameters():
            v.grad = grads[k].clone()
        optimizer.step()
    worst = 0.0
    for k, v in model.named_parameters():
        d_ref = (runs["ref_final"][k] - setup["sd0"][k]).numpy()
        err = _rel_err((v.detach() - setup["sd0"][k]).numpy(), d_ref)
        worst = max(worst, err)
        assert err <= 1e-3, f"{k}: {err:.2e} of max|change|"
    print(f"worst parameter-change error {worst:.2e} of max|change|")


def test_head_gradients_match_jax_on_the_same_features(setup):
    """Everything after the backbone on numpy features: gradients w.r.t. the
    head parameters and the feature maps."""
    cfg_j, model, jb, tb = setup["cfg_j"], setup["model"], setup["jb"], setup["tb"]
    rng = np.random.RandomState(5)
    feats = {f"p{l}": rng.randn(2, 64 >> l, 64 >> l, 32).astype(np.float32)
             for l in range(2, 7)}
    jm = JPanopticFPN(cfg_j.model)

    def heads(m, f):
        _, sem = m.sem_seg_head(f, jb.sem_seg, train=True)
        rpn = m.proposal_generator(f, jb.image_sizes, gt=jb.gt, train=True)
        roi = m.roi_heads(f, rpn.proposal_boxes, rpn.proposal_scores,
                          rpn.proposal_valid, jb.image_sizes, gt=jb.gt, train=True)
        return {**sem, **rpn.losses, **roi}

    def loss_fn(p, f):
        losses = jm.apply({"params": p, "batch_stats": setup["stats"]}, f,
                          method=heads, rngs={"sampling": jax.random.PRNGKey(0)})
        return sum(losses.values()), losses

    (_, ref_losses), (gp, gf) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(
            setup["params"], {k: jnp.array(v) for k, v in feats.items()})

    model.load_state_dict(setup["sd0"])
    model.train()
    model.zero_grad(set_to_none=True)
    tf = {k: torch.from_numpy(v.copy()).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_() for k, v in feats.items()}
    losses = model.losses_from_features(tf, tb.image_sizes, tb.gt, tb.sem_seg,
                                        torch.Generator().manual_seed(0))
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(losses[k]), float(ref_losses[k]), rtol=1e-4,
                                   err_msg=k)
    sum(losses.values()).backward()
    worst = 0.0
    for k, v in tf.items():
        err = _rel_err(v.grad.permute(0, 2, 3, 1).numpy(), gf[k])
        worst = max(worst, err)
        assert err <= 1e-4, f"d/d{k}: {err:.2e} of max|grad|"
    ref = from_jax(_np_tree(gp), setup["stats"])
    heads_seen = 0
    for k, v in model.named_parameters():
        if k.startswith("backbone."):
            assert v.grad is None
            continue
        heads_seen += 1
        err = _rel_err(v.grad.numpy(), ref[k])
        worst = max(worst, err)
        assert err <= 1e-4, f"{k}: {err:.2e} of max|grad|"
    assert heads_seen == 65
    print(f"worst head gradient error {worst:.2e} of max|grad|")


def test_train_forward_refuses_a_model_in_eval_mode(setup):
    model, tb = setup["model"], setup["tb"]
    model.eval()
    with pytest.raises(ValueError, match="training mode"):
        model(tb.images, tb.image_sizes, gt=tb.gt, sem_seg_gt=tb.sem_seg, train=True)
    out = model(tb.images, tb.image_sizes)          # inference still works
    assert not out.sem_seg_logits.requires_grad
    model.train()


# ---------------------------------------------------------------------------
# the optimizer alone, on a hand-made parameter tree
# ---------------------------------------------------------------------------

class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        from u2seg_torch.ops.norms import BatchNorm2d

        self.conv = torch.nn.Conv2d(3, 4, 1)
        self.bn = BatchNorm2d(4)
        self.fc = torch.nn.Linear(4, 2)


@pytest.mark.parametrize("overrides", [
    {},                                                   # the u2seg recipe
    {"bias_lr_factor": 2.0, "weight_decay_bias": 1e-3, "weight_decay_norm": 1e-4,
     "nesterov": True},
    {"clip_type": "value", "clip_value": 0.05, "weight_decay_norm": None},
    {"clip_gradients": False, "scheduler": "WarmupCosineLR", "max_iter": 6},
    {"warmup_method": "constant", "steps": (2, 4), "gamma": 0.1},
])
def test_optimizer_matches_optax(overrides):
    from u2seg_torch.solver import build_lr_schedule
    from u2seg_tpu.solver import build_lr_schedule as jbuild_lr_schedule

    cfg_t, cfg_j = tconfig.Config().solver, jconfig.Config().solver
    for cfg in (cfg_t, cfg_j):
        cfg.warmup_iters = 3
        cfg.weight_decay = 1e-2
        for k, v in overrides.items():
            setattr(cfg, k, v)
    for count in range(7):
        np.testing.assert_allclose(build_lr_schedule(cfg_t)(count),
                                   float(jbuild_lr_schedule(cfg_j)(count)), rtol=1e-6)

    rng = np.random.RandomState(3)
    toy = _Toy()
    names = {"conv.weight": ("conv", "kernel"), "conv.bias": ("conv", "bias"),
             "bn.weight": ("bn", "scale"), "bn.bias": ("bn", "bias"),
             "fc.weight": ("fc", "kernel"), "fc.bias": ("fc", "bias")}
    params = {"conv": {}, "bn": {}, "fc": {}}
    with torch.no_grad():
        for k, v in toy.named_parameters():
            v.copy_(torch.from_numpy(rng.randn(*v.shape).astype(np.float32)))
            params[names[k][0]][names[k][1]] = jnp.array(v.numpy().copy())
    opt = build_optimizer(cfg_t, toy)
    assert [g["name"] for g in opt.param_groups] == ["regular", "norm", "bias"]
    tx = jbuild_optimizer(cfg_j)
    state = tx.init(params)
    for _ in range(5):
        grads = {"conv": {}, "bn": {}, "fc": {}}
        for k, v in toy.named_parameters():
            g = (rng.randn(*v.shape) * 0.3).astype(np.float32)
            v.grad = torch.from_numpy(g.copy())     # the clip works in place
            grads[names[k][0]][names[k][1]] = jnp.array(g)
        opt.step()
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for k, v in toy.named_parameters():
            np.testing.assert_allclose(
                v.detach().numpy(), np.asarray(params[names[k][0]][names[k][1]]),
                rtol=2e-5, atol=1e-6, err_msg=k)
    assert opt.state_dict()["param_groups"][0]["count"] == 5
