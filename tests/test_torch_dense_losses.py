"""The training forward of u2seg_torch's RetinaNet and FCOS vs the JAX package
on the CPU, and the one norm module a dense head shares across the levels.

Both sides take one numpy batch (b=2, 128x128, 4 gt boxes of 12-100 px, one
slot padding) and one variable tree drawn from numpy
(``torch_zoo_parity.random_variables``). Dense detectors sample nothing, so
the losses are deterministic. The trunk is FrozenBN and the FPN has no norm.

Tolerances: every loss rtol 1e-4. Gradients, as relative L2 errors over
all the tensors together and as each tensor's max error over its max|grad|:
the heads on the SAME numpy levels (parameters and levels) L2 <= 1e-4 and
each <= 1e-2; the whole model L2 <= 1e-3 and each <= 5e-2 (JAX's
stop-gradient zeros where the port has none: the frozen norms). The towers
are 4 convs of 256 channels at every level: among their ~1e6 ReLU inputs
some lie within f32 noise of 0 and open on one side only, which moves the
gradients upstream of them (measured: heads L2 2.9e-5 with one level at
4.0e-3, RetinaNet; whole model L2 2.6e-4, worst 6.5e-3, FCOS; the other
runs <= 2.1e-6 everywhere). The head's BatchNorm statistics after one train
forward (one EMA update per level, 5 in all): rtol 1e-3 with atol 1e-3 *
max. Train-mode BN amplifies the two packages' different summation orders
from layer to layer (measured max error over max: 3e-7, 6e-6, 2.5e-5 and
2.0e-4 at the class tower's 1st to 4th norm).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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

CASES = {"retinanet": ("RetinaNet", {}), "fcos": ("FCOS", {}),
         "retinanet_bn": ("RetinaNet", {"retinanet.head_norm": "BN"})}
KEYS = {"RetinaNet": ["loss_box_reg", "loss_cls"],
        "FCOS": ["loss_fcos_cls", "loss_fcos_ctr", "loss_fcos_loc"]}


def batch():
    rng = np.random.RandomState(3)
    b, g = 2, 4
    xy = rng.rand(b, g, 2) * 60
    wh = rng.rand(b, g, 2) * 88 + 12
    boxes = np.minimum(np.concatenate([xy, xy + wh], -1), 127).astype(np.float32)
    valid = np.ones((b, g), bool)
    valid[1, -1] = False
    return dict(images=(rng.rand(b, 128, 128, 3) * 255).astype(np.float32),
                sizes=np.array([[128, 128]] * b, np.int32), boxes=boxes,
                classes=rng.randint(0, 5, (b, g)).astype(np.int32), valid=valid)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def _errors(pairs):
    """[(name, got, ref)] -> (relative L2 over all, {name: max error / max|ref|})."""
    num = sum(float(((np.asarray(g) - np.asarray(r)) ** 2).sum()) for _, g, r in pairs)
    den = sum(float((np.asarray(r) ** 2).sum()) for _, _, r in pairs)
    return (num / den) ** 0.5, {k: _rel(g, r) for k, g, r in pairs}


@functools.lru_cache(maxsize=None)
def run(case, heads_only=False):
    """JAX losses, gradients (w.r.t. params and, with ``heads_only``, the
    levels) and batch statistics; the port's after one backward."""
    meta, over = CASES[case]
    over = dict({"resnet.norm": "FrozenBN", "fpn.norm": ""}, **over)
    cfg_j, cfg_t = tiny(jconfig.Config(), meta, **over), tiny(tconfig.Config(), meta, **over)
    bt = batch()
    images, sizes = jnp.asarray(bt["images"]), jnp.asarray(bt["sizes"])
    jgt = JGt(*(jnp.asarray(bt[k]) for k in ("boxes", "classes", "valid")))
    jm = jbuild(cfg_j)
    v = random_variables(jm, 8, images, sizes, train=False)
    rng = np.random.RandomState(5)
    feats = {f"p{l}": rng.randn(2, 128 >> l, 128 >> l, 32).astype(np.float32)
             for l in range(3, 8)}

    def loss_fn(p, f):
        var = {"params": p, "batch_stats": v.get("batch_stats", {})}
        if heads_only:
            losses, new = jm.apply(var, f, method=lambda m, f: m.head(f, sizes, gt=jgt, train=True),
                                   mutable=["batch_stats"])
        else:
            losses, new = jm.apply(var, images, sizes, gt=jgt, train=True,
                                   mutable=["batch_stats"])
        return sum(losses.values()), (losses, new)

    (_, (ref_losses, new)), (gp, gf) = jax.jit(
        jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
            jnp_tree(v["params"]), {k: jnp.asarray(x) for k, x in feats.items()})
    ref_losses, gp, gf, new = jax.tree_util.tree_map(np.asarray, (ref_losses, gp, gf, new))

    model = port_from(v, build_model(cfg_t, device="cpu")).train()
    gt = GtInstances(*(torch.from_numpy(bt[k]) for k in ("boxes", "classes", "valid")))
    tsizes = torch.from_numpy(bt["sizes"])
    tf = {k: torch.from_numpy(x.copy()).permute(0, 3, 1, 2).requires_grad_()
          for k, x in feats.items()}
    if heads_only:
        losses = model._detector[0](tf, tsizes, gt=gt, train=True)
    else:
        losses = model(torch.from_numpy(bt["images"]), tsizes, gt=gt, train=True)
    sum(losses.values()).backward()
    stats = {**v.get("batch_stats", {}), **new.get("batch_stats", {})}
    return dict(
        meta=meta, model=model, keys=KEYS[meta], losses={k: float(x.detach()) for k, x in losses.items()},
        ref_losses=ref_losses, grads={k: p.grad for k, p in model.named_parameters()},
        ref_grads=from_jax(gp, v.get("batch_stats", {})),
        feature_grads={k: x.grad.permute(0, 2, 3, 1).numpy() for k, x in tf.items()
                       if x.grad is not None},
        ref_feature_grads=gf, ref_state=from_jax(v["params"], stats))


@pytest.mark.parametrize("case", ["retinanet", "fcos"])
@pytest.mark.parametrize("heads_only", [False, True])
def test_losses_match_jax(case, heads_only):
    r = run(case, heads_only)
    assert sorted(r["losses"]) == sorted(r["ref_losses"]) == r["keys"]
    for k in r["keys"]:
        assert np.isfinite(r["losses"][k]) and r["losses"][k] > 0, k
        np.testing.assert_allclose(r["losses"][k], float(r["ref_losses"][k]), rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("case", ["retinanet", "fcos"])
def test_head_gradients_match_jax_on_the_same_features(case):
    r = run(case, True)
    assert sorted(r["feature_grads"]) == ["p3", "p4", "p5", "p6", "p7"]
    pairs = [(f"d/d{k}", g, r["ref_feature_grads"][k]) for k, g in r["feature_grads"].items()]
    pairs += [(k, g.numpy(), r["ref_grads"][k].numpy()) for k, g in r["grads"].items()
              if k.startswith("head.")]
    assert len(pairs) >= 25
    l2, errs = _errors(pairs)
    worst = max(errs, key=errs.get)
    print(f"heads: relative L2 {l2:.2e}, worst {errs[worst]:.2e} ({worst})")
    assert l2 <= 1e-4, l2
    assert errs[worst] <= 1e-2, (worst, errs[worst])


@pytest.mark.parametrize("case", ["retinanet", "fcos"])
def test_whole_model_gradients_match_jax(case):
    r = run(case)
    pairs = []
    for k, g in r["grads"].items():
        ref = r["ref_grads"][k]
        if g is None:
            assert "bottom_up" in k and ".norm." in k, k
            assert float(ref.abs().max()) == 0, k
            continue
        assert float(ref.abs().max()) > 0, f"{k}: zero reference gradient"
        pairs.append((k, g.numpy(), ref.numpy()))
    l2, errs = _errors(pairs)
    worst = max(errs, key=errs.get)
    print(f"whole model: relative L2 {l2:.2e}, worst {errs[worst]:.2e} ({worst})")
    assert l2 <= 1e-3, l2
    assert errs[worst] <= 5e-2, (worst, errs[worst])


def test_one_norm_serves_every_level():
    """A BN head in training: each tower norm is applied to the 5 levels in
    turn, so its running statistics take 5 EMA updates per forward, in the
    JAX package as in the port."""
    r = run("retinanet_bn")
    state, ref = r["model"].state_dict(), r["ref_state"]
    names = [k for k in state if k.startswith("head.") and "running_" in k]
    assert len(names) == 16                    # 8 norms (4 per tower), mean and var
    for k in names:
        init = 0.0 if k.endswith("mean") else 1.0
        assert not torch.allclose(state[k], torch.full_like(state[k], init)), k
        np.testing.assert_allclose(state[k].numpy(), ref[k].numpy(), rtol=1e-3,
                                   atol=1e-3 * float(ref[k].abs().max()), err_msg=k)
    # one update moves a statistic by 0.1 of the way; five by 1 - 0.9 ** 5
    mean = state["head.cls_subnet.1.running_mean"]
    assert float(mean.abs().max()) > 0
