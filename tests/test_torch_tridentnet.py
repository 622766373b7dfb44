"""TridentNet of the port against the JAX package on the CPU: the trident
conv, the block (eval and training-mode BN, gradients) and a stage, from
the JAX variable trees loaded through ``weights.projects_from_jax``. The
norm numbering is checked against the tree that the JAX module's ``init``
returns.

Tolerances (f32): outputs, BN statistics and gradients 1e-4 relative to the
largest reference value.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_zoo_parity import close, jnp_tree, random_variables
from u2seg_tpu.projects import tridentnet as JT
from u2seg_torch.projects import tridentnet as PT
from u2seg_torch.weights import projects_from_jax, seeded_init

torch.set_num_threads(1)


def nchw(x):
    return torch.from_numpy(np.array(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def port(module, v):
    module.load_state_dict(projects_from_jax(module, v["params"], v.get("batch_stats", {})))
    return module


@pytest.mark.parametrize("dilations", [(1, 2, 3), (1, 3)])
def test_trident_conv_matches_jax(dilations):
    rng = np.random.RandomState(len(dilations))
    xs = [rng.randn(2, 9, 11, 5).astype(np.float32) for _ in dilations]
    jm = JT.TridentConv(features=6, dilations=dilations)
    v = random_variables(jm, 1, [jnp.asarray(x) for x in xs])
    ref = jm.apply(jnp_tree(v), [jnp.asarray(x) for x in xs])
    pm = port(PT.TridentConv(5, 6, dilations), v)
    for g, r in zip(pm([nchw(x) for x in xs]), ref):
        close(nhwc(g), r)


def test_block_norm_numbering_follows_flax():
    jm = JT.TridentBlock(out_channels=8, bottleneck_channels=4)
    x = jnp.zeros((1, 6, 6, 5))
    tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (x, x, x)))["params"]
    pm = PT.TridentBlock(5, 8, 4)
    widths = {f"BatchNorm_{i}": tuple(tree[f"BatchNorm_{i}"]["scale"].shape) for i in range(9)}
    assert widths == {f"BatchNorm_{i}": tuple(n.weight.shape) for i, n in enumerate(pm.norms)}
    assert widths["BatchNorm_3"] == (4,) and widths["BatchNorm_4"] == (8,)


@pytest.mark.parametrize("cin,train", [(5, False), (5, True), (8, True)])
def test_trident_block_matches_jax(cin, train):
    rng = np.random.RandomState(cin + train)
    xs = [rng.randn(2, 10, 12, cin).astype(np.float32) for _ in range(3)]
    cot = [rng.randn(2, 10, 12, 8).astype(np.float32) for _ in range(3)]
    jm = JT.TridentBlock(out_channels=8, bottleneck_channels=4)
    jx = tuple(jnp.asarray(x) for x in xs)
    v = random_variables(jm, 2, jx)

    def loss(params, xs_):
        out = jm.apply({"params": params, "batch_stats": jnp_tree(v["batch_stats"])}, xs_,
                       train=train, mutable=["batch_stats"] if train else False)
        out, new = out if train else (out, {})
        return sum(jnp.sum(o * c) for o, c in zip(out, cot)), (out, new)

    (_, (ref, new)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp_tree(v["params"]), jx)
    pm = port(PT.TridentBlock(cin, 8, 4), v).train(train)
    txs = [nchw(x).requires_grad_() for x in xs]
    out = pm(txs)
    sum((o * nchw(c)).sum() for o, c in zip(out, cot)).backward()
    for g, r in zip(out, ref):
        close(nhwc(g), r)
    for g, r in zip(txs, gx):
        close(nhwc(g.grad), r, name="dx")
    close(pm.trident.weight.grad.permute(2, 3, 1, 0).numpy(), gp["trident"]["kernel"],
          name="d trident kernel")
    close(pm.conv1.weight.grad.permute(2, 3, 1, 0).numpy(), gp["conv1"]["kernel"], name="d conv1")
    if train:
        for i, n in enumerate(pm.norms):
            close(n.running_mean, new["batch_stats"][f"BatchNorm_{i}"]["mean"], name=f"mean {i}")
            close(n.running_var, new["batch_stats"][f"BatchNorm_{i}"]["var"], name=f"var {i}")


class _JStage(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return JT.make_trident_stage(x, 2, 8, 4)


def test_trident_stage_and_shared_kernel_gradient():
    rng = np.random.RandomState(5)
    x = rng.randn(1, 12, 12, 6).astype(np.float32)
    jm = _JStage()
    v = random_variables(jm, 3, jnp.asarray(x))
    ref = jm.apply(jnp_tree(v), jnp.asarray(x))
    pm = port(PT.make_trident_stage(6, 2, 8, 4), v).eval()
    out = pm(nchw(x))
    assert len(out) == 3
    for g, r in zip(out, ref):
        close(nhwc(g), r)
    # the shared kernel's gradient is the sum of the three branches' parts
    blk = seeded_init(PT.TridentBlock(6, 8, 4), seed=1).eval()
    xt = nchw(x)
    parts = []
    for i in range(3):
        blk.zero_grad()
        blk([xt] * 3)[i].square().sum().backward()
        parts.append(blk.trident.weight.grad.clone())
    blk.zero_grad()
    sum(o.square().sum() for o in blk([xt] * 3)).backward()
    close(blk.trident.weight.grad, (parts[0] + parts[1] + parts[2]).numpy())
