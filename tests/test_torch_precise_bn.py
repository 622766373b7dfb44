"""u2seg_torch's PreciseBN against the JAX package's (counterpart of
``tests/engine/test_precise_bn.py``), on the CPU.

- ``estimate_bn_stats`` recovers each batch's moments from the EMA update and
  averages them: on inputs whose per-channel moments are set by hand it
  returns their true mean (rtol 1e-5);
- on the same batches through a small stack (BN, ReLU, 1x1 mix, BN) it
  equals the JAX function over flax's BatchNorm at rtol 1e-5 (atol 1e-6 *
  max); a frozen BN is left alone;
- with no batches nothing changes;
- the ``PreciseBN`` hook inside ``DefaultTrainer`` (the small config of
  ``tests/test_torch_train_step.py``) leaves the statistics of its last
  batches through the trained model (rtol 1e-4: the recovery's rounding
  depends on the statistics it starts from).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import tiny
from u2seg_tpu.engine.precise_bn import estimate_bn_stats as jestimate_bn_stats
from u2seg_tpu.ops.norms import BatchNorm as JBatchNorm
from u2seg_torch import config as tconfig
from u2seg_torch.engine.precise_bn import PreciseBN, estimate_bn_stats
from u2seg_torch.engine.train_loop import DefaultTrainer, batch_from_numpy
from u2seg_torch.engine.trainer import bn_running_stats
from u2seg_torch.ops.norms import BatchNorm2d
from u2seg_torch.parallel.mesh import shard_batch
from u2seg_torch.testing import fake_loader

torch.set_num_threads(1)
C = 4


def test_estimate_bn_stats_recovers_true_mean():
    rng = np.random.RandomState(0)
    means = rng.randn(10, C).astype(np.float32)
    variances = (rng.rand(10, C) + 0.5).astype(np.float32)
    # two values per channel, mean +- std: exactly these biased moments
    batches = [torch.from_numpy(np.stack([m - np.sqrt(v), m + np.sqrt(v)], -1)
                                ).view(1, C, 1, 2) for m, v in zip(means, variances)]
    bn = BatchNorm2d(C).train()
    n = estimate_bn_stats(bn, bn, batches, num_iters=10)
    assert n == 10
    np.testing.assert_allclose(bn.running_mean.numpy(), means.mean(0), rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), variances.mean(0), rtol=1e-5)


def test_estimate_bn_stats_stops_at_num_iters():
    bn = BatchNorm2d(C).train()
    seen = []
    n = estimate_bn_stats(bn, lambda b: seen.append(b) or bn(b),
                          (torch.randn(2, C, 3, 3) for _ in range(10)), num_iters=3)
    assert n == 3 and len(seen) == 3


def test_estimate_bn_stats_no_batches():
    bn = BatchNorm2d(C).train()
    with torch.no_grad():
        bn.running_mean.fill_(0.25)
    assert estimate_bn_stats(bn, bn, [], num_iters=5) == 0
    assert torch.equal(bn.running_mean, torch.full((C,), 0.25))
    assert torch.equal(bn.running_var, torch.ones(C))


class JStack(fnn.Module):
    mix: np.ndarray

    @fnn.compact
    def __call__(self, x):
        x = JBatchNorm(momentum=0.9, epsilon=1e-5)(x, use_running_average=False)
        x = jnp.einsum("bhwc,cd->bhwd", jnp.maximum(x, 0), self.mix)
        return JBatchNorm(momentum=0.9, epsilon=1e-5)(x, use_running_average=False)


def test_estimate_bn_stats_matches_jax_on_a_bn_stack():
    rng = np.random.RandomState(1)
    mix = rng.randn(C, C).astype(np.float32)
    batches = [(rng.randn(2, 5, 6, C) * rng.uniform(0.5, 3) + rng.randn()).astype(np.float32)
               for _ in range(6)]
    scales = [rng.uniform(0.5, 1.5, C).astype(np.float32) for _ in range(2)]
    biases = [(rng.randn(C) * 0.2).astype(np.float32) for _ in range(2)]
    means = [(rng.randn(C) * 0.3).astype(np.float32) for _ in range(2)]
    variances = [rng.uniform(0.5, 2, C).astype(np.float32) for _ in range(2)]

    # JAX: flax BatchNorm, mutable batch_stats
    jm = JStack(mix)
    params = {f"BatchNorm_{i}": {"scale": jnp.array(scales[i]), "bias": jnp.array(biases[i])}
              for i in range(2)}
    stats = {f"BatchNorm_{i}": {"mean": jnp.array(means[i]), "var": jnp.array(variances[i])}
             for i in range(2)}

    def apply_fn(p, s, batch):
        _, new = jm.apply({"params": p, "batch_stats": s}, jnp.array(batch),
                          mutable=["batch_stats"])
        return new["batch_stats"]

    ref = jestimate_bn_stats(apply_fn, params, stats, batches, num_iters=5)

    # the port: the same stack, NCHW, and a frozen BN that must not move
    conv = torch.nn.Conv2d(C, C, 1, bias=False)
    bns = [BatchNorm2d(C), BatchNorm2d(C), BatchNorm2d(C, frozen=True)]
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(mix.T.copy()).view(C, C, 1, 1))
        for i in range(2):
            bns[i].weight.copy_(torch.from_numpy(scales[i]))
            bns[i].bias.copy_(torch.from_numpy(biases[i]))
            bns[i].running_mean.copy_(torch.from_numpy(means[i]))
            bns[i].running_var.copy_(torch.from_numpy(variances[i]))
        bns[2].running_mean.fill_(0.5)
    model = torch.nn.Sequential(bns[0], torch.nn.ReLU(), conv, bns[1], bns[2]).train()
    params_before = [p.clone() for p in model.parameters()]
    n = estimate_bn_stats(
        model, model, (torch.from_numpy(b).permute(0, 3, 1, 2) for b in batches),
        num_iters=5)
    assert n == 5
    for i in range(2):
        for got, key in ((bns[i].running_mean, "mean"), (bns[i].running_var, "var")):
            r = np.asarray(ref[f"BatchNorm_{i}"][key])
            np.testing.assert_allclose(got.numpy(), r, rtol=1e-5,
                                       atol=1e-6 * float(np.abs(r).max()))
    assert torch.equal(bns[2].running_mean, torch.full((C,), 0.5))
    assert torch.equal(bns[2].running_var, torch.ones(C))
    assert len(bn_running_stats(model)) == 4
    for a, b in zip(params_before, model.parameters()):
        assert torch.equal(a, b)


def test_precise_bn_hook_in_the_trainer(tmp_path):
    cfg = tiny(tconfig.Config())
    cfg.output_dir = str(tmp_path)
    raw = list(zip(range(6), fake_loader(np.random.RandomState(3), b=2)))
    raw = [d for _, d in raw]
    trainer = DefaultTrainer(cfg, raw, device="cpu")
    trainer.register_hooks([PreciseBN(period=2, num_iters=2)])
    trainer.train(max_iter=2)             # steps 0, 1; the hook after step 1 and at the end
    got = [t.clone() for t in bn_running_stats(trainer.model)]

    ref_trainer = DefaultTrainer(cfg, raw[:2], device="cpu")
    ref_trainer.train(max_iter=2)
    model = ref_trainer.model
    before = [t.clone() for t in bn_running_stats(model)]
    gen = torch.Generator()

    def forward(d):
        b = shard_batch(ref_trainer.mesh, batch_from_numpy(d))
        model(b.images, b.image_sizes, gt=b.gt, sem_seg_gt=b.sem_seg, train=True,
              generator=gen.manual_seed(0))

    estimate_bn_stats(model, forward, raw[4:6], num_iters=2)
    ref = bn_running_stats(model)
    assert len(got) == len(ref) == 2 * 37
    for g, r, b in zip(got, ref, before):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(r.abs().max()))
        assert not torch.equal(g, b)
    for k, v in trainer.model.named_parameters():
        assert torch.equal(v, dict(model.named_parameters())[k]), k
