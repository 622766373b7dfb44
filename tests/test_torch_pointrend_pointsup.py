"""PointRend and PointSup of the port against the JAX package on the CPU.

Inputs are drawn from numpy; the JAX functions work on one ROI and are
mapped with ``jax.vmap``, the port's take the ROI axis. Random draws (the
uncertain-point candidates, the annotation subset) are made on the JAX side
and passed to the port, which then computes the rest.

Tolerances (f32): sampling and losses 1e-5 relative to the largest
reference value, the point head and the refined masks 1e-4; indices and
labels exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_zoo_parity import close, exact, jnp_tree, numpy_of, random_variables
from u2seg_tpu.projects import pointrend as JP
from u2seg_tpu.projects import pointsup as JS
from u2seg_torch.projects import pointrend as PP
from u2seg_torch.projects import pointsup as PS
from u2seg_torch.weights import projects_from_jax

torch.set_num_threads(1)


def close5(got, ref, name=""):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(numpy_of(got), ref, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(ref).max(initial=0.0)), 1e-30),
                               err_msg=name)


def t(x):
    return torch.from_numpy(np.array(x))


def blocky_logits(rng, n, m, block=4):
    """Coarse logits constant on block x block tiles, values on a 0.5 grid:
    uncertainty and upsampled maps full of exact ties."""
    small = np.round(rng.randn(n, m // block, m // block) * 2) / 2
    return np.repeat(np.repeat(small, block, 1), block, 2).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_point_sample_matches_jax_inside_and_outside_the_map(seed):
    rng = np.random.RandomState(seed)
    feat = rng.randn(3, 7, 9, 5).astype(np.float32)             # (N, H, W, C)
    pts = rng.uniform(-0.2, 1.2, (3, 40, 2)).astype(np.float32)   # some taps off the map
    ref = jax.vmap(JP.point_sample)(jnp.asarray(feat), jnp.asarray(pts))
    got = PP.point_sample(t(feat.transpose(0, 3, 1, 2)), t(pts))
    close5(got, ref)


def test_uncertainty_and_uncertain_points_with_jax_draws():
    rng = np.random.RandomState(2)
    n, num, m = 4, 14, 16
    coarse = blocky_logits(rng, n, m)
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    ref = jax.vmap(lambda k, c: JP.sample_uncertain_points(k, c, num))(keys, jnp.asarray(coarse))
    # the JAX draws: split the key, uniform candidates, uniform fill
    n_over, n_imp = int(num * 3.0), int(num * 0.75)
    over, rand = [], []
    for k in keys:
        r1, r2 = jax.random.split(k)
        over.append(np.asarray(jax.random.uniform(r1, (n_over, 2))))
        rand.append(np.asarray(jax.random.uniform(r2, (num - n_imp, 2))))
    got = PP.sample_uncertain_points(t(coarse), num, draws=(t(np.stack(over)), t(np.stack(rand))))
    exact(got, ref)
    exact(PP.calculate_uncertainty(t(coarse)), JP.calculate_uncertainty(jnp.asarray(coarse)))
    # a draw from the port's generator: the same shapes, points in [0, 1)
    drawn = PP.sample_uncertain_points(t(coarse), num, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (n, num, 2) and bool(((drawn >= 0) & (drawn < 1)).all())


def _point_head(seed, c, k=1, hidden=16, layers=3):
    jm = JP.PointHead(num_classes=k, hidden=hidden, num_layers=layers)
    v = random_variables(jm, seed, jnp.zeros((5, c)), jnp.zeros((5, k)))
    pm = PP.PointHead(c, k, hidden, layers)
    pm.load_state_dict(projects_from_jax(pm, v["params"]))
    return jm, v, pm


@pytest.mark.parametrize("k,layers", [(1, 3), (3, 2)])
def test_point_head_matches_jax(k, layers):
    rng = np.random.RandomState(k)
    jm, v, pm = _point_head(4, 6, k, layers=layers)
    fine = rng.randn(2, 11, 6).astype(np.float32)
    coarse = rng.randn(2, 11, k).astype(np.float32)
    ref = jm.apply(jnp_tree(v), jnp.asarray(fine), jnp.asarray(coarse))
    close(pm(t(fine), t(coarse)), ref)


@pytest.mark.parametrize("steps,points,out", [(2, 30, 56), (3, 196, 40)])
def test_refine_mask_inference_matches_jax_on_tied_maps(steps, points, out):
    rng = np.random.RandomState(steps)
    n, c = 3, 6
    jm, v, pm = _point_head(5, c)
    fine = rng.randn(n, 14, 14, c).astype(np.float32)
    coarse = blocky_logits(rng, n, 16)
    apply = lambda f, co: jm.apply(jnp_tree(v), f, co)  # noqa: E731
    ref = jax.vmap(lambda f, co: JP.refine_mask_inference(apply, f, co, steps, points, out))(
        jnp.asarray(fine), jnp.asarray(coarse))
    got = PP.refine_mask_inference(pm, t(fine.transpose(0, 3, 1, 2)), t(coarse), steps, points, out)
    assert got.shape == ref.shape
    close(got, ref)


def test_point_rend_mask_loss_matches_jax_with_its_draws():
    rng = np.random.RandomState(7)
    n, c, num = 3, 6, 20
    jm, v, pm = _point_head(6, c)
    fine = rng.randn(n, 14, 14, c).astype(np.float32)
    coarse = blocky_logits(rng, n, 28)
    gt = (rng.rand(n, 28, 28) > 0.5).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(8), n)
    apply = lambda f, co: jm.apply(jnp_tree(v), f, co)  # noqa: E731
    ref = jax.vmap(lambda k, f, co, g: JP.point_rend_mask_loss(
        k, apply, f, co, lambda p: JP.point_sample(g[..., None], p)[:, 0], num))(
        keys, jnp.asarray(fine), jnp.asarray(coarse), jnp.asarray(gt))
    over, rand = [], []
    for k in keys:
        r1, r2 = jax.random.split(k)
        over.append(np.asarray(jax.random.uniform(r1, (num * 3, 2))))
        rand.append(np.asarray(jax.random.uniform(r2, (num - int(num * 0.75), 2))))
    tgt = t(gt)
    got = PP.point_rend_mask_loss(pm, t(fine.transpose(0, 3, 1, 2)), t(coarse),
                                  lambda p: PP.point_sample(tgt[:, None], p)[..., 0], num,
                                  draws=(t(np.stack(over)), t(np.stack(rand))))
    close5(got, np.mean(np.asarray(ref)))


def test_point_coords_and_ignore_rule_match_jax():
    rng = np.random.RandomState(9)
    boxes = np.concatenate([rng.rand(5, 2) * 50, rng.rand(5, 2) * 50 + 60], 1).astype(np.float32)
    boxes[4, 2] = boxes[4, 0]                      # a degenerate box
    pts = (rng.rand(5, 8, 2) * 130 - 10).astype(np.float32)
    labels = rng.randint(-1, 2, (5, 8)).astype(np.float32)
    rc, rl = JS.prepare_point_targets(jnp.asarray(boxes), jnp.asarray(pts), jnp.asarray(labels))
    gc, gl = PS.prepare_point_targets(t(boxes), t(pts), t(labels))
    close5(gc, rc)
    exact(gl, rl)
    close5(PS.get_point_coords_wrt_box(t(boxes), t(pts)),
           JS.get_point_coords_wrt_box(jnp.asarray(boxes), jnp.asarray(pts)))


@pytest.mark.parametrize("num_sample", [0, 4, 10, 12])
def test_sample_point_annotations_with_jax_noise(num_sample):
    rng = np.random.RandomState(10)
    coords = rng.rand(3, 10, 2).astype(np.float32)
    labels = rng.randint(0, 2, (3, 10)).astype(np.float32)
    key = jax.random.PRNGKey(num_sample)
    rc, rl = JS.sample_point_annotations(key, jnp.asarray(coords), jnp.asarray(labels), num_sample)
    noise = np.asarray(jax.random.uniform(key, (3, 10)))
    gc, gl = PS.sample_point_annotations(t(coords), t(labels), num_sample, noise=t(noise))
    exact(gc, rc)
    exact(gl, rl)
    # drawn by the port: a subset of each row's points, fixed shapes
    dc, dl = PS.sample_point_annotations(t(coords), t(labels), num_sample,
                                         generator=torch.Generator().manual_seed(1))
    keep = num_sample if 0 < num_sample < 10 else 10
    assert dc.shape == (3, keep, 2) and dl.shape == (3, keep)
    for r in range(3):
        rows = {tuple(p) for p in coords[r].tolist()}
        assert {tuple(p) for p in dc[r].tolist()} <= rows
        assert len({tuple(p) for p in dc[r].tolist()}) == keep


def test_annotations_to_point_arrays_equal():
    annos = [{"point_coords": [[1, 2], [3, 4], [5, 6]], "point_labels": [1, 0, 1]},
             {"point_coords": [], "point_labels": []},
             {"point_coords": [[7, 8]] * 9, "point_labels": [1] * 9}]
    for cap, ppi in ((4, 5), (2, 3)):
        ref = JS.annotations_to_point_arrays(annos, cap, ppi)
        got = PS.annotations_to_point_arrays(annos, cap, ppi)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            exact(g, r)


@pytest.mark.parametrize("seed", [0, 1])
def test_point_sup_mask_loss_matches_jax(seed):
    rng = np.random.RandomState(seed)
    r, m, k, p = 6, 14, 4, 10
    logits = (rng.randn(r, m, m, k) * 3).astype(np.float32)
    classes = rng.randint(0, k + 2, r).astype(np.int32)        # some out of range (clamped)
    coords = rng.uniform(-0.1, 1.1, (r, p, 2)).astype(np.float32)
    labels = rng.randint(-1, 2, (r, p)).astype(np.float32)
    valid = rng.rand(r) > 0.3
    ref = JS.point_sup_mask_loss(jnp.asarray(logits), jnp.asarray(classes), jnp.asarray(coords),
                                 jnp.asarray(labels), jnp.asarray(valid))
    got = PS.point_sup_mask_loss(t(logits.transpose(0, 3, 1, 2)), t(classes), t(coords),
                                 t(labels), t(valid))
    close5(got, ref)
