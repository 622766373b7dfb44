"""``u2seg_torch/pseudo/semisup.py`` against ``u2seg_tpu/pseudo/semisup.py``:
the FixMatch losses, the EMA, one FixMatch step and one fine-tune step on a
tiny BN conv net (f32, 1e-5), and RandAugmentMC bit for bit.

The port's step takes ``torch.optim.SGD(momentum=m)``, the JAX one
``optax.sgd(lr, momentum=m)``: the same arithmetic.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from u2seg_tpu.pseudo import semisup as J
from u2seg_torch.ops.norms import BatchNorm2d
from u2seg_torch.pseudo import semisup as P

torch.set_num_threads(1)
TOL = 1e-5
CLASSES = 3
LR, MOMENTUM = 0.1, 0.9


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * max(1.0, float(np.abs(ref).max())))


class JNet(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = True):
        x = fnn.Conv(8, (3, 3), padding=[(1, 1), (1, 1)], name="conv")(x)
        x = fnn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                          name="bn")(x)
        x = jnp.mean(fnn.relu(x), axis=(1, 2))
        return fnn.Dense(CLASSES, name="fc")(x)


class TNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.bn = BatchNorm2d(8)
        self.fc = nn.Linear(8, CLASSES)

    def forward(self, x):
        return self.fc(torch.relu(self.bn(self.conv(x))).mean(dim=(2, 3)))


def _nets(seed=0):
    rng = np.random.RandomState(seed)
    jnet = JNet()
    v = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), train=False)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.5), v["params"])
    tnet = TNet()
    with torch.no_grad():
        tnet.conv.weight.copy_(torch.from_numpy(np.array(params["conv"]["kernel"]).transpose(3, 2, 0, 1)))
        tnet.conv.bias.copy_(torch.from_numpy(np.array(params["conv"]["bias"])))
        tnet.bn.weight.copy_(torch.from_numpy(np.array(params["bn"]["scale"])))
        tnet.bn.bias.copy_(torch.from_numpy(np.array(params["bn"]["bias"])))
        tnet.fc.weight.copy_(torch.from_numpy(np.array(params["fc"]["kernel"]).T))
        tnet.fc.bias.copy_(torch.from_numpy(np.array(params["fc"]["bias"])))
    return jnet, {"params": params, "batch_stats": v["batch_stats"]}, tnet


def _images(rng, n):
    x = rng.randn(n, 8, 8, 3).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _logits(rng, n):
    x = (rng.randn(n, CLASSES) * 3).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("threshold", [0.0, 0.6, 0.95])
def test_fixmatch_losses_match_jax(threshold):
    rng = np.random.RandomState(int(threshold * 100))
    cfg = J.FixMatchConfig(threshold=threshold, temperature=0.7, lambda_u=1.5)
    tcfg = P.FixMatchConfig(threshold=threshold, temperature=0.7, lambda_u=1.5)
    (jx, tx), (jw, tw), (js, ts) = _logits(rng, 4), _logits(rng, 12), _logits(rng, 12)
    targets = rng.randint(0, CLASSES, 4)
    ref = J.fixmatch_losses(jx, jnp.asarray(targets), jw, js, cfg)
    got = P.fixmatch_losses(tx, torch.from_numpy(targets), tw, ts, tcfg)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k])


def test_ema_update_matches_jax_over_the_parameters_only():
    _, v, tnet = _nets(1)
    _, v2, tnet2 = _nets(2)
    ref = J.ema_update(v["params"], v2["params"], 0.9)
    running = tnet.bn.running_mean.clone()
    got = P.ema_update(tnet, tnet2, 0.9)
    _close(got["conv.weight"], np.asarray(ref["conv"]["kernel"]).transpose(3, 2, 0, 1))
    _close(got["bn.weight"], ref["bn"]["scale"])
    _close(got["fc.weight"], np.asarray(ref["fc"]["kernel"]).T)
    assert torch.equal(tnet.bn.running_mean, running)            # buffers untouched


def test_one_fixmatch_step_matches_jax():
    jnet, v, tnet = _nets(3)
    cfg = J.FixMatchConfig(threshold=0.4, mu=2, ema_decay=0.9)
    tcfg = P.FixMatchConfig(threshold=0.4, mu=2, ema_decay=0.9)
    opt = optax.sgd(LR, momentum=MOMENTUM)
    state = dict(params=v["params"], ema_params=jax.tree_util.tree_map(jnp.copy, v["params"]),
                 batch_stats=v["batch_stats"],
                 opt_state=opt.init(v["params"]))

    def apply_fn(variables, images, train):
        return jnet.apply(variables, images, train=train, mutable=["batch_stats"])

    jstep = J.make_fixmatch_train_step(apply_fn, opt, cfg, has_batch_stats=True)
    tstep = P.make_fixmatch_train_step(
        tnet, torch.optim.SGD(tnet.parameters(), lr=LR, momentum=MOMENTUM), tcfg)
    rng = np.random.RandomState(4)
    for _ in range(2):                       # the second step moves the momentum too
        (jx, tx), (jw, tw), (js, ts) = _images(rng, 4), _images(rng, 8), _images(rng, 8)
        targets = rng.randint(0, CLASSES, 4)
        state, jl = jstep(state, jx, jnp.asarray(targets), jw, js)
        tl = tstep(tx, torch.from_numpy(targets), tw, ts)
        for k in jl:
            _close(tl[k], jl[k])
    p, e = state["params"], state["ema_params"]
    _close(tnet.conv.weight, np.asarray(p["conv"]["kernel"]).transpose(3, 2, 0, 1))
    _close(tnet.fc.weight, np.asarray(p["fc"]["kernel"]).T)
    _close(tnet.bn.bias, p["bn"]["bias"])
    _close(tstep.ema_params["fc.weight"], np.asarray(e["fc"]["kernel"]).T)
    _close(tstep.ema_params["conv.bias"], e["conv"]["bias"])
    # the joint batch statistics of the concatenated forward
    _close(tnet.bn.running_mean, state["batch_stats"]["bn"]["mean"])
    _close(tnet.bn.running_var, state["batch_stats"]["bn"]["var"])


class JTrunk(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = fnn.Conv(6, (3, 3), padding=[(1, 1), (1, 1)], name="conv")(x)
        return jnp.mean(fnn.relu(x), axis=(1, 2))


class TTrunk(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 6, 3, padding=1)

    def forward(self, x):
        return torch.relu(self.conv(x)).mean(dim=(2, 3))


@pytest.mark.parametrize("freeze", [False, True])
def test_one_finetune_step_matches_jax(freeze):
    rng = np.random.RandomState(5)
    trunk, head = JTrunk(), fnn.Dense(CLASSES)
    pb = trunk.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"]
    ph = head.init(jax.random.PRNGKey(1), jnp.zeros((1, 6)))["params"]
    draw = lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.5)  # noqa: E731
    params = {"backbone": jax.tree_util.tree_map(draw, pb),
              "head": jax.tree_util.tree_map(draw, ph)}
    opt = optax.sgd(LR, momentum=MOMENTUM)
    state = dict(params=params, opt_state=opt.init(params))
    jstep = J.make_finetune_train_step(
        lambda p, x: trunk.apply({"params": p}, x), lambda p, f: head.apply({"params": p}, f),
        opt, freeze_backbone=freeze)
    ttrunk, thead = TTrunk(), nn.Linear(6, CLASSES)
    with torch.no_grad():
        ttrunk.conv.weight.copy_(torch.from_numpy(
            np.asarray(params["backbone"]["conv"]["kernel"]).transpose(3, 2, 0, 1)))
        ttrunk.conv.bias.copy_(torch.from_numpy(np.array(params["backbone"]["conv"]["bias"])))
        thead.weight.copy_(torch.from_numpy(np.array(params["head"]["kernel"]).T))
        thead.bias.copy_(torch.from_numpy(np.array(params["head"]["bias"])))
    before = ttrunk.conv.weight.detach().clone()
    tstep = P.make_finetune_train_step(
        ttrunk, thead, torch.optim.SGD(list(ttrunk.parameters()) + list(thead.parameters()),
                                       lr=LR, momentum=MOMENTUM), freeze_backbone=freeze)
    for _ in range(2):
        jx, tx = _images(rng, 6)
        targets = rng.randint(0, CLASSES, 6)
        state, jm = jstep(state, jx, jnp.asarray(targets))
        tm = tstep(tx, torch.from_numpy(targets))
        _close(tm["loss"], jm["loss"])
        _close(tm["top1"], jm["top1"])
    p = state["params"]
    _close(ttrunk.conv.weight, np.asarray(p["backbone"]["conv"]["kernel"]).transpose(3, 2, 0, 1))
    _close(thead.weight, np.asarray(p["head"]["kernel"]).T)
    assert torch.equal(ttrunk.conv.weight, before) == freeze


@pytest.mark.parametrize("hw", [(32, 32), (37, 53), (61, 40), (96, 96)])
def test_randaugment_mc_equals_jax_bit_for_bit(hw):
    for seed in range(50):
        img = np.random.RandomState(10_000 + seed).randint(0, 256, hw + (3,)).astype(np.uint8)
        ref = J.randaugment_mc(img, np.random.RandomState(seed))
        got = P.randaugment_mc(img, np.random.RandomState(seed))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)
