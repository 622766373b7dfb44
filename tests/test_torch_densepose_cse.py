"""DensePose CSE of the port against the JAX package on the CPU: the
embedding helpers, both vertex embedders (a ``vertex_feature`` embedder's
fixed features from flax's ``constants`` collection), the predictor, the
embedding and cycle losses (the cycle loss at JAX's Gumbel top-k picks,
passed in), the loss dict, ``DensePoseCseHeads`` and nearest-vertex
inference. Weights come through ``weights.projects_from_jax``.

Tolerances (f32): embeddings, distances and losses 1e-5 relative to the
largest reference value, the conv heads' outputs and gradients 1e-4; vertex
ids and masks exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_zoo_parity import close, exact, jnp_tree, numpy_of, random_variables
from u2seg_tpu.projects import densepose_cse as JC
from u2seg_torch.projects import densepose_cse as PC
from u2seg_torch.weights import projects_from_jax, seeded_init

torch.set_num_threads(1)


def close5(got, ref, name=""):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(numpy_of(got), ref, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(ref).max(initial=0.0)), 1e-30),
                               err_msg=name)


def t(x):
    return torch.from_numpy(np.array(x))


def nchw(x):
    return t(np.asarray(x).transpose(0, 3, 1, 2))


def drawn_tree(module, seed, *args, **kwargs):
    """Every variable of ``module.init`` drawn from numpy at 0.3 std."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.RandomState(seed)
    tree = jax.tree_util.tree_map(lambda s: (rng.randn(*s.shape) * 0.3).astype(np.float32), shapes)
    return dict(tree)


MESHES = (JC.MeshSpec("smpl_27554", 40), JC.MeshSpec("cat", 30, "vertex_feature", 5),
          JC.MeshSpec("dog", 25, "vertex_feature", 4, True))


def _cfgs(**kw):
    jm = MESHES
    pm = tuple(PC.MeshSpec(m.name, m.num_vertices, m.embedder_type, m.feature_dim,
                           m.features_trainable) for m in jm)
    return JC.CSEConfig(embed_size=6, meshes=jm, **kw), PC.CSEConfig(embed_size=6, meshes=pm, **kw)


def test_normalize_and_distances_match_jax():
    rng = np.random.RandomState(0)
    a, b = rng.randn(7, 5).astype(np.float32), rng.randn(9, 5).astype(np.float32)
    a[0] = 0.0
    close5(PC.normalize_embeddings(t(a)), JC.normalize_embeddings(jnp.asarray(a)))
    close5(PC.squared_euclidean_distance_matrix(t(a), t(b)),
           JC.squared_euclidean_distance_matrix(jnp.asarray(a), jnp.asarray(b)))


def test_embedder_with_constants_matches_jax():
    jcfg, pcfg = _cfgs()
    jm = JC.Embedder(jcfg)
    v = drawn_tree(jm, 1)
    assert "constants" in v and "features" in v["constants"]["embedder_cat"]
    ref = jm.apply(jnp_tree(v))
    pm = PC.Embedder(pcfg)
    pm.load_state_dict(projects_from_jax(pm, v["params"], constants=v["constants"]))
    assert "embedder_cat.features" in dict(pm.named_buffers())
    assert "embedder_dog.features" in dict(pm.named_parameters())
    got = pm()
    assert list(got) == list(ref) == pm.mesh_names()
    for k in ref:
        close5(got[k], ref[k], name=k)
        close5(pm(k), jm.apply(jnp_tree(v), k), name=k)
    seeded = seeded_init(PC.Embedder(pcfg), seed=0)
    w = seeded.embedder_smpl_27554.embeddings.detach()
    assert 0.005 < float(w.std()) < 0.015


def test_predictor_matches_jax():
    jcfg, pcfg = _cfgs()
    x = np.random.RandomState(2).randn(3, 7, 7, 8).astype(np.float32)
    jm = JC.DensePoseEmbeddingPredictor(jcfg)
    v = random_variables(jm, 2, jnp.asarray(x))
    ref = jm.apply(jnp_tree(v), jnp.asarray(x))
    pm = PC.DensePoseEmbeddingPredictor(pcfg, 8)
    pm.load_state_dict(projects_from_jax(pm, v["params"]))
    got = pm(nchw(x))
    for k in ref:
        close(got[k].detach().permute(0, 2, 3, 1), ref[k], name=k)


def _points(rng, n, p, meshes):
    arrs = (rng.rand(n, p).astype(np.float32), rng.rand(n, p).astype(np.float32),
            rng.randint(0, 60, (n, p)).astype(np.int32),
            rng.randint(0, len(meshes), (n, p)).astype(np.int32), rng.rand(n, p) > 0.2)
    return JC.CsePoints(*(jnp.asarray(a) for a in arrs)), PC.CsePoints(*(t(a) for a in arrs))


def _mesh_embeddings(rng):
    e = [JC.normalize_embeddings(jnp.asarray(rng.randn(m.num_vertices, 6).astype(np.float32)))
         for m in MESHES]
    return e, [t(np.asarray(a)) for a in e]


def _jax_picks(key, fg, num):
    flat = jnp.asarray(fg.reshape(fg.shape[0], -1))
    score = jnp.where(flat, jax.random.gumbel(key, flat.shape), -jnp.inf)
    return np.asarray(jax.lax.top_k(score, num)[1])


def test_embedding_and_cycle_losses_match_jax():
    rng = np.random.RandomState(3)
    n, s, p = 4, 12, 9
    emb = rng.randn(n, s, s, 6).astype(np.float32)
    jp, pp = _points(rng, n, p, MESHES)
    roi_valid = np.array([True, True, False, True])
    je, pe = _mesh_embeddings(rng)
    ref = JC.embedding_loss(jnp.asarray(emb), jp, je, jnp.asarray(roi_valid), 0.5)
    got = PC.embedding_loss(nchw(emb), pp, pe, t(roi_valid), 0.5)
    assert set(got) == set(ref)
    for m in ref:
        close5(got[m], ref[m], name=str(m))
    fg = rng.rand(n, s, s) > 0.5
    fg[3] = False                                   # a ROI with no foreground
    key = jax.random.PRNGKey(4)
    ref = JC.pix_to_shape_cycle_loss(jnp.asarray(emb), jnp.asarray(fg), jnp.asarray(roi_valid), je,
                                     key, num_pixels=20)
    got = PC.pix_to_shape_cycle_loss(nchw(emb), t(fg), t(roi_valid), pe,
                                     t(_jax_picks(key, fg, 20)).long())
    close5(got, ref)
    drawn = PC.pix2shape_picks(t(fg), 20, torch.Generator().manual_seed(0))
    assert drawn.shape == (n, 20)
    fg_flat = t(fg).reshape(n, -1)
    for r in range(3):                               # enough foreground: all picks are fg
        if int(fg_flat[r].sum()) >= 20:
            assert bool(fg_flat[r][drawn[r]].all()) and len(set(drawn[r].tolist())) == 20


@pytest.mark.parametrize("gt_size", [12, 5])
def test_cse_loss_dict_matches_jax(gt_size):
    rng = np.random.RandomState(gt_size)
    jcfg, pcfg = _cfgs(pix2shape_enabled=True, pix2shape_num_pixels=15)
    n, s = 3, 12
    # a coarse segmentation coarser than the embedding: the cycle loss
    # resizes its foreground to the embedding's grid
    out = {"embedding": rng.randn(n, s, s, 6).astype(np.float32),
           "coarse_segm": rng.randn(n, gt_size, gt_size, 2).astype(np.float32)}
    jp, pp = _points(rng, n, 7, MESHES)
    gt = rng.randint(0, 2, (n, gt_size, gt_size)).astype(np.int32)
    roi_valid = np.array([True, False, True])
    je, pe = _mesh_embeddings(rng)
    key = jax.random.PRNGKey(gt_size)
    ref = JC.densepose_cse_losses({k: jnp.asarray(a) for k, a in out.items()}, jp, jnp.asarray(gt),
                                  jnp.asarray(roi_valid), je, jcfg, rng=key)
    fg = np.asarray(jax.image.resize(jnp.asarray(gt > 0, jnp.float32), (n, s, s), "nearest")) > 0.5
    picks = t(_jax_picks(key, fg, 15)).long()
    got = PC.densepose_cse_losses({k: nchw(a) for k, a in out.items()}, pp, t(gt), t(roi_valid),
                                  pe, pcfg, picks=picks)
    assert set(got) == set(ref)
    for k in ref:
        close5(got[k], ref[k], name=k)


def test_cse_heads_and_nearest_vertices_match_jax():
    rng = np.random.RandomState(6)
    jcfg, pcfg = _cfgs()
    b, r, res = 2, 3, 7
    f = {f"p{i + 2}": rng.randn(b, 32 // 2 ** i, 32 // 2 ** i, 8).astype(np.float32)
         for i in range(4)}
    jf, pf = {k: jnp.asarray(a) for k, a in f.items()}, {k: nchw(a) for k, a in f.items()}
    bx = rng.rand(b, r, 4).astype(np.float32) * 60
    bx[..., 2:] = bx[..., :2] + 40.0
    s = 4 * res
    jp, pp = _points(rng, b * r, 8, MESHES)
    gt = rng.randint(0, 2, (b * r, s, s)).astype(np.int32)
    live = rng.rand(b, r) > 0.2
    je, pe = _mesh_embeddings(rng)
    jm = JC.DensePoseCseHeads(jcfg, head_convs=2, head_dim=16, pooler_resolution=res)
    v = random_variables(jm, 7, jf, jnp.asarray(bx))

    def loss(params):
        out = jm.apply({"params": params}, jf, jnp.asarray(bx), train=True, points=jp,
                       coarse_segm_gt=jnp.asarray(gt), roi_live=jnp.asarray(live),
                       mesh_embeddings=je)
        return sum(out.values()), out

    (_, ref), grads = jax.value_and_grad(loss, has_aux=True)(jnp_tree(v["params"]))
    pm = PC.DensePoseCseHeads(pcfg, 8, head_convs=2, head_dim=16, pooler_resolution=res)
    pm.load_state_dict(projects_from_jax(pm, v["params"]))
    got = pm(pf, t(bx), train=True, points=pp, coarse_segm_gt=t(gt), roi_live=t(live),
             mesh_embeddings=pe)
    for k in ref:
        close5(got[k], ref[k], name=k)
    sum(got.values()).backward()
    close(pm.head.body_conv_fcn2.weight.grad.permute(2, 3, 1, 0).numpy(),
          grads["head"]["body_conv_fcn2"]["kernel"], name="d body_conv_fcn2")
    ref = jm.apply(jnp_tree(v), jf, jnp.asarray(bx))
    with torch.no_grad():
        got = pm(pf, t(bx))
    for k in ref:
        close(got[k].permute(0, 1, 3, 4, 2), ref[k], name=k)
    emb = np.asarray(ref["embedding"]).reshape(b * r, s, s, 6)
    seg = np.asarray(ref["coarse_segm"]).reshape(b * r, s, s, 2)
    gi, gf = PC.cse_nearest_vertices(nchw(emb), nchw(seg), pe[0])
    for i in range(b * r):
        ri, rf = JC.cse_nearest_vertices(jnp.asarray(emb[i]), jnp.asarray(seg[i]), je[0])
        exact(gi[i], ri)
        exact(gf[i], rf)


def test_normalize_gradient_is_finite_on_zero_rows_where_jax_is_nan():
    """An all-zero row (a ROI whose pooled features are all zero gives one):
    the JAX package's ``jnp.linalg.norm`` differentiates ``sqrt`` at 0 and
    returns NaN; the port floors under the root, with the same values."""
    e = np.zeros((2, 3), np.float32)
    e[1] = [0.3, -0.4, 1.2]
    ref = np.asarray(jax.grad(lambda a: JC.normalize_embeddings(a).sum())(jnp.asarray(e)))
    assert np.isnan(ref[0]).all() and np.isfinite(ref[1]).all()
    te = t(e).requires_grad_()
    out = PC.normalize_embeddings(te)
    out.sum().backward()
    close5(out, JC.normalize_embeddings(jnp.asarray(e)))
    assert bool(torch.isfinite(te.grad).all())
    close5(te.grad[1], ref[1])
