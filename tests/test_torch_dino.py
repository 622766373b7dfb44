"""u2seg_torch's DINO ViT against the JAX package's (``u2seg_tpu/pseudo/dino.py``)
on the CPU at a small size: dim 64, depth 2, 4 heads, patch 8, 32x32 crops.

- ``dino_from_jax`` inverts ``convert_dino_vit`` exactly (both ways);
- the forward (cls and patch features) for facets k, q, v and out, and
  ``masked_crop_features``, at rtol 1e-5 (atol 1e-6);
- an official-name state dict through ``load_dino_state_dict`` (with the
  position embedding resized) against ``convert_dino_vit`` at rtol 1e-5;
- ``interpolate_pos_embed`` up (4 -> 6) and down (14 -> 2, where
  ``jax.image.resize`` antialiases) against JAX at rtol 1e-6 (atol 1e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2seg_tpu.pseudo import dino as jdino
from u2seg_torch.pseudo import dino as tdino
from u2seg_torch.weights import dino_from_jax

torch.set_num_threads(1)

DIM, DEPTH, HEADS, PATCH, SIDE = 64, 2, 4, 8, 32


def jax_params(seed=0, side=SIDE):
    model = jdino.DinoViT(patch_size=PATCH, dim=DIM, depth=DEPTH, num_heads=HEADS)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, side, side, 3)))["params"]
    # non-trivial norms, biases and cls token
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32) * 0.05, params)


def crops(n=3, side=SIDE, seed=1):
    return np.random.RandomState(seed).randn(n, side, side, 3).astype(np.float32)


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_dino_from_jax_inverts_convert_dino_vit():
    params = jax_params()
    sd = dino_from_jax(params)
    port = tdino.DinoViT(patch_size=PATCH, dim=DIM, depth=DEPTH, num_heads=HEADS, img_size=SIDE)
    assert sorted(sd) == sorted(port.state_dict())
    back = jdino.convert_dino_vit({k: v.numpy() for k, v in sd.items()}, depth=DEPTH)
    a, b = dict(flat(params)), dict(flat(back))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    again = dino_from_jax(back)
    for k in sd:
        assert torch.equal(sd[k], again[k]), k


@pytest.mark.parametrize("facet", ["k", "q", "v", "out"])
def test_forward_matches_jax(facet):
    params = jax_params()
    x = crops()
    jm = jdino.DinoViT(patch_size=PATCH, dim=DIM, depth=DEPTH, num_heads=HEADS, facet=facet)
    jcls, jpatch = jm.apply({"params": params}, jnp.asarray(x))
    port = tdino.DinoViT(patch_size=PATCH, dim=DIM, depth=DEPTH, num_heads=HEADS,
                         facet=facet, img_size=SIDE)
    port.load_state_dict(dino_from_jax(params))
    with torch.no_grad():
        tcls, tpatch = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert tpatch.shape == (3, (SIDE // PATCH) ** 2, DIM)
    np.testing.assert_allclose(tcls.numpy(), np.asarray(jcls), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tpatch.numpy(), np.asarray(jpatch), rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        tfeat = tdino.masked_crop_features(port, torch.from_numpy(x).permute(0, 3, 1, 2))
    jfeat = jdino.masked_crop_features(jm, params, jnp.asarray(x))
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), rtol=1e-5, atol=1e-6)


def test_official_state_dict_loads_like_convert_dino_vit():
    """A state dict in DINO's names, its position embedding on a 7 x 7 grid
    (56 px at patch 8), loaded for 32 px crops (4 x 4) by both packages."""
    port = tdino.seeded_dino_state(
        tdino.DinoViT(patch_size=PATCH, dim=DIM, depth=DEPTH, num_heads=HEADS, img_size=56),
        seed=3)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    state["head.weight"] = np.zeros((4, DIM), np.float32)      # no use to the model: skipped
    jp = jdino.convert_dino_vit(state, depth=DEPTH, grid_hw=(4, 4))
    jm = jdino.DinoViT(patch_size=PATCH, dim=DIM, depth=DEPTH, num_heads=HEADS)
    x = crops()
    jcls, jpatch = jm.apply({"params": jp}, jnp.asarray(x))
    model = tdino.DinoViT(patch_size=PATCH, dim=DIM, depth=DEPTH, num_heads=HEADS, img_size=SIDE)
    tdino.load_dino_state_dict(model, state, grid_hw=(4, 4))
    with torch.no_grad():
        tcls, tpatch = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tcls.numpy(), np.asarray(jcls), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tpatch.numpy(), np.asarray(jpatch), rtol=1e-5, atol=1e-6)
    del state["norm.weight"]
    with pytest.raises(KeyError, match="norm.weight"):
        tdino.load_dino_state_dict(model, state, grid_hw=(4, 4))


@pytest.mark.parametrize("g0,gh,gw", [(4, 6, 6), (14, 2, 2), (14, 14, 3), (5, 3, 8)])
def test_interpolate_pos_embed_matches_jax(g0, gh, gw):
    pos = np.random.RandomState(g0 * 100 + gh).randn(1, 1 + g0 * g0, 16).astype(np.float32)
    want = jdino.interpolate_pos_embed(pos, gh, gw)
    got = tdino.interpolate_pos_embed(pos, gh, gw)
    assert got.shape == (1, 1 + gh * gw, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[:, 0].numpy(), pos[:, 0])


def test_wrong_grid_and_facet_are_refused():
    with pytest.raises(ValueError, match="facet"):
        tdino.DinoViT(facet="x")
    model = tdino.DinoViT(patch_size=PATCH, dim=DIM, depth=1, num_heads=HEADS, img_size=SIDE)
    with pytest.raises(ValueError, match="patches"):
        model(torch.zeros(1, 3, 2 * SIDE, SIDE))
