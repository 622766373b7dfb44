"""u2seg_torch's kNN, k-means and USL selection against the JAX package's
(``u2seg_tpu/pseudo/kmeans.py``) on the CPU, on continuous seeded features
(``torch.topk`` promises no order among ties, ``lax.top_k`` puts the lower
index first):

- ``knn``, cosine and L2, N not a multiple of the chunk: distances at rtol
  1e-5 (atol 1e-6), indices equal;
- the port's Lloyd iterations from the JAX package's k-means++ centroids (same
  ``PRNGKey``) against JAX ``kmeans``: centroids at 1e-5, assignments equal;
  also from centroids of which one never gets a member (JAX run with the
  same centroids through its own loop);
- the port's k-means++ draws follow the D^2 weights (chi-square over 4000
  seeds at a 1e-4 significance level) and repeat for one generator seed;
- ``density_from_knn`` at 1e-6 on the same distances (1e-5 on each
  package's own kNN, atol 1e-6), ``select_representatives`` equal,
  ``_selection_regularizer`` in both exclusion modes at rtol 1e-5,
  ``select_representatives_regularized`` equal indices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from u2seg_tpu.pseudo import kmeans as jkm
from u2seg_torch.pseudo import kmeans as tkm

torch.set_num_threads(1)


def gaussian_clusters(rng, k=4, per=50, d=16, spread=0.05):
    centers = rng.randn(k, d).astype(np.float32) * 2
    feats = np.concatenate([centers[i] + rng.randn(per, d).astype(np.float32) * spread
                            for i in range(k)])
    return feats, np.repeat(np.arange(k), per)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_knn_matches_jax(metric):
    feats = np.random.RandomState(0).randn(53, 12).astype(np.float32)
    jd, ji = jkm.knn(jnp.asarray(feats), k=5, metric=metric, chunk=16)
    td, ti = tkm.knn(torch.from_numpy(feats), k=5, metric=metric, chunk=16)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    assert not (ti.numpy() == np.arange(53)[:, None]).any()


@pytest.mark.parametrize("metric,seed", [("cosine", 0), ("l2", 1), ("cosine", 2)])
def test_lloyd_from_jax_seeding_matches_jax_kmeans(metric, seed):
    feats, _ = gaussian_clusters(np.random.RandomState(seed), k=5, per=30, d=8, spread=0.6)
    x = np.asarray(jkm._normalize(jnp.asarray(feats))) if metric == "cosine" else feats
    init = np.array(jkm._kmeans_pp_init(jax.random.PRNGKey(seed), jnp.asarray(x), 6, metric))
    jc, ja = jkm.kmeans(jax.random.PRNGKey(seed), jnp.asarray(feats), 6, num_iters=15,
                        metric=metric)
    tx = tkm._normalize(torch.from_numpy(feats)) if metric == "cosine" else torch.from_numpy(feats)
    tc, ta = tkm.lloyd(tx, torch.from_numpy(init), 15, metric, chunk=64)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_lloyd_keeps_an_empty_cluster_like_jax(metric, monkeypatch):
    """The last centroid lies opposite every point, so it never gets a member
    and keeps its place (renormalised for cosine) in both packages."""
    rng = np.random.RandomState(5)
    feats = (np.abs(rng.randn(40, 6)) + 0.1).astype(np.float32)
    x = feats / np.linalg.norm(feats, axis=1, keepdims=True) if metric == "cosine" else feats
    init = np.concatenate([x[[0, 7, 19]], -np.ones((1, 6), np.float32) / np.float32(np.sqrt(6))])
    monkeypatch.setattr(jkm, "_kmeans_pp_init", lambda rng, x, k, m: jnp.asarray(init))
    with jax.disable_jit():
        jc, ja = jkm.kmeans(jax.random.PRNGKey(0), jnp.asarray(feats), 4, num_iters=6,
                            metric=metric)
    tx = tkm._normalize(torch.from_numpy(feats)) if metric == "cosine" else torch.from_numpy(feats)
    tc, ta = tkm.lloyd(tx, torch.from_numpy(init), 6, metric, chunk=16)
    assert 3 not in ta.tolist()
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc[3].numpy(), init[3], rtol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_kmeans_pp_draws_follow_the_d2_weights(metric):
    x = torch.tensor([[0.0, 1.0], [1.0, 0.2], [2.0, 3.0], [-1.0, 0.5], [0.5, -2.0]])
    if metric == "cosine":
        x = tkm._normalize(x)
    n, trials = len(x), 4000
    firsts, pairs = np.zeros(n), np.zeros((n, n))
    for s in range(trials):
        c = tkm._kmeans_pp_init(x, 2, metric, torch.Generator().manual_seed(s))
        f = int(torch.nonzero((x == c[0]).all(1))[0])
        t = int(torch.nonzero((x == c[1]).all(1))[0])
        firsts[f] += 1
        pairs[f, t] += 1
    assert stats.chisquare(firsts).pvalue > 1e-4
    for f in range(n):
        if metric == "cosine":
            d2 = torch.clamp(1 - x @ x[f], min=0.0)
        else:
            d2 = ((x - x[f]) ** 2).sum(1)
        p = torch.clamp(d2, min=1e-20).double().numpy()
        p /= p.sum()
        assert pairs[f, f] == 0
        keep = np.arange(n) != f
        assert stats.chisquare(pairs[f, keep], p[keep] * pairs[f].sum()).pvalue > 1e-4
    a = tkm._kmeans_pp_init(x, 4, metric, torch.Generator().manual_seed(9))
    b = tkm._kmeans_pp_init(x, 4, metric, torch.Generator().manual_seed(9))
    assert torch.equal(a, b)


def test_kmeans_recovers_clusters_and_repeats():
    feats, labels = gaussian_clusters(np.random.RandomState(0))
    runs = [tkm.kmeans(torch.from_numpy(feats), 4, num_iters=30, metric=m,
                       generator=torch.Generator().manual_seed(3))
            for m in ("l2", "cosine", "cosine")]
    for _, a in runs:
        a = a.numpy()
        purity = sum(np.bincount(labels[a == c]).max() for c in np.unique(a))
        assert purity / len(labels) > 0.95
    assert torch.equal(runs[1][1], runs[2][1]) and torch.equal(runs[1][0], runs[2][0])
    np.testing.assert_allclose(torch.linalg.vector_norm(runs[1][0], dim=1).numpy(), 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_density_and_representatives_match_jax(metric):
    feats, _ = gaussian_clusters(np.random.RandomState(2), k=3, per=20, spread=0.3)
    jd, _ = jkm.knn(jnp.asarray(feats), k=5, metric=metric)
    td, _ = tkm.knn(torch.from_numpy(feats), k=5, metric=metric)
    jden = np.asarray(jkm.density_from_knn(jd, metric))
    tden = tkm.density_from_knn(torch.from_numpy(np.array(jd)), metric).numpy()
    np.testing.assert_allclose(tden, jden, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tkm.density_from_knn(td, metric).numpy(), jden, rtol=1e-5,
                               atol=1e-6)
    assign = np.random.RandomState(3).randint(0, 4, len(feats))
    assign[assign == 2] = 1                                  # cluster 2 empty
    np.testing.assert_array_equal(
        tkm.select_representatives(feats, assign, jden, 4),
        jkm.select_representatives(feats, assign, jden, 4))


@pytest.mark.parametrize("exclude_same_cluster", [True, False])
def test_selection_regularizer_matches_jax(exclude_same_cluster):
    rng = np.random.RandomState(4)
    feats = rng.randn(45, 8).astype(np.float32)
    labels = rng.randint(0, 6, 45).astype(np.int32)
    src = np.array([3, 11, 17, 28, 40, 44])
    args = (0.8, 4, exclude_same_cluster)
    want = jkm._selection_regularizer(jnp.asarray(feats), jnp.asarray(feats[src]),
                                      jnp.asarray(src, jnp.int32), jnp.asarray(labels),
                                      *args, chunk=16)
    got = tkm._selection_regularizer(torch.from_numpy(feats), torch.from_numpy(feats[src]),
                                     torch.from_numpy(src), torch.from_numpy(labels).long(),
                                     *args, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("exclude_same_cluster", [True, False])
def test_regularized_selection_matches_jax(exclude_same_cluster):
    feats, _ = gaussian_clusters(np.random.RandomState(1), k=6, per=30, d=8, spread=0.4)
    assign = np.asarray(jkm.kmeans(jax.random.PRNGKey(1), jnp.asarray(feats), 7,
                                   num_iters=20, metric="l2")[1])
    dists, _ = jkm.knn(jnp.asarray(feats), k=5, metric="l2")
    nd = np.asarray(jkm.density_from_knn(dists, metric="l2"), np.float64) + 1e-3
    kw = dict(num_clusters=7, final_sample_num=6, iters=3, w=0.5, momentum=0.25,
              horizon_num=4, alpha=1.0, exclude_same_cluster=exclude_same_cluster)
    want = jkm.select_representatives_regularized(feats, assign, nd, **kw)
    got = tkm.select_representatives_regularized(torch.from_numpy(feats), assign, nd, **kw)
    assert got.dtype == np.int64 and len(got) == 6
    np.testing.assert_array_equal(got, want)
