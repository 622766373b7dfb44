"""u2seg_torch's USL-T heads against the JAX package's (``u2seg_tpu/pseudo/uslt.py``)
on the CPU:

- ``sharpen``, the local and global losses and ``uslt_loss`` at rtol 1e-6
  (atol 1e-7) on the same logits;
- one ``make_uslt_train_step`` step (``torch.optim.Adam``) against the JAX
  step with ``optax.adam`` on the same parameters and batch: losses and the
  updated parameters at rtol 1e-6 (atol 1e-7); three steps more with the
  losses at the same tolerance and the parameters at atol 1e-6 (lr 1e-2);
- ``train_uslt`` reaches purity > 0.9 on separable data, as
  ``tests/pseudo/test_uslt.py`` checks the JAX one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from u2seg_tpu.pseudo import uslt as juslt
from u2seg_torch.pseudo import uslt as tuslt
from u2seg_torch.pseudo.kmeans import knn

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-7)


def logits(seed, n=12, k=5, scale=3.0):
    return np.random.RandomState(seed).randn(n, k).astype(np.float32) * scale


@pytest.mark.parametrize("threshold", [0.0, 0.4])
def test_losses_match_jax(threshold):
    a, b = logits(0), logits(1)
    np.testing.assert_allclose(
        tuslt.sharpen(torch.softmax(torch.from_numpy(a), -1), 0.3).numpy(),
        np.asarray(juslt.sharpen(jax.nn.softmax(jnp.asarray(a), -1), 0.3)), **TOL)
    np.testing.assert_allclose(
        float(tuslt.local_consistency_loss(torch.from_numpy(a), torch.from_numpy(b), 0.5,
                                           threshold)),
        float(juslt.local_consistency_loss(jnp.asarray(a), jnp.asarray(b), 0.5, threshold)),
        **TOL)
    np.testing.assert_allclose(float(tuslt.global_entropy_loss(torch.from_numpy(a))),
                               float(juslt.global_entropy_loss(jnp.asarray(a))), **TOL)
    heads_a = [logits(s) for s in (2, 3, 4)]
    heads_b = [logits(s) for s in (5, 6, 7)]
    tt, tm = tuslt.uslt_loss([torch.from_numpy(x) for x in heads_a],
                             [torch.from_numpy(x) for x in heads_b])
    jt, jm = juslt.uslt_loss([jnp.asarray(x) for x in heads_a],
                             [jnp.asarray(x) for x in heads_b])
    np.testing.assert_allclose(float(tt), float(jt), **TOL)
    for k in ("loss_local", "loss_global"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)


def test_train_step_matches_optax_adam():
    rng = np.random.RandomState(0)
    d, k, heads = 16, 6, 3
    jm = juslt.ClusteringHeads(k, heads)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, d)))["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + np.float32(0.01), params)
    tx = optax.adam(1e-2)
    opt_state = tx.init(params)
    jstep = juslt.make_uslt_train_step(jm, tx)

    model = tuslt.ClusteringHeads(d, k, heads)
    with torch.no_grad():
        for i in range(heads):
            getattr(model, f"head{i}").weight.copy_(
                torch.from_numpy(np.array(params[f"head{i}"]["kernel"]).T))
            getattr(model, f"head{i}").bias.copy_(
                torch.from_numpy(np.array(params[f"head{i}"]["bias"])))
    tstep = tuslt.make_uslt_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-2))
    for step in range(4):
        fa = rng.randn(32, d).astype(np.float32)
        fb = fa + rng.randn(32, d).astype(np.float32) * 0.1
        params, opt_state, jmet = jstep(params, opt_state, jnp.asarray(fa), jnp.asarray(fb))
        tmet = tstep(torch.from_numpy(fa), torch.from_numpy(fb))
        for key in ("loss", "loss_local", "loss_global"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), **TOL)
        # Adam's step is lr * m / sqrt(v) per element: after the first, an
        # element whose gradient is near 0 turns rounding into up to
        # lr * 1e-4 of drift
        ptol = TOL if step == 0 else dict(rtol=1e-6, atol=1e-6)
        for i in range(heads):
            head = getattr(model, f"head{i}")
            np.testing.assert_allclose(head.weight.detach().numpy().T,
                                       np.asarray(params[f"head{i}"]["kernel"]), **ptol)
            np.testing.assert_allclose(head.bias.detach().numpy(),
                                       np.asarray(params[f"head{i}"]["bias"]), **ptol)


def test_train_uslt_clusters_separable_data():
    rng = np.random.RandomState(0)
    centers = rng.randn(3, 8).astype(np.float32) * 3
    feats = np.concatenate([centers[i] + rng.randn(40, 8).astype(np.float32) * 0.05
                            for i in range(3)])
    labels = np.repeat(np.arange(3), 40)
    f = torch.from_numpy(feats)
    _, nbr = knn(f, k=5, metric="l2", chunk=32)
    model, assign, entropies = tuslt.train_uslt(
        f, nbr, num_clusters=3, steps=300, batch_size=64,
        generator=torch.Generator().manual_seed(0))
    a = assign.numpy()
    purity = sum(np.bincount(labels[a == c]).max() for c in np.unique(a)) / len(labels)
    assert purity > 0.9
    assert len(entropies) == 3 and all(np.isfinite(entropies))
    assert isinstance(model, tuslt.ClusteringHeads)
