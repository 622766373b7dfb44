"""u2seg_torch ROIAlign poolers vs the JAX package.

- the gather pooler (``pooler_impl="gather"``) vs ``multilevel_roi_align``;
- the multilevel kernel's plain twin (``pooler_impl="pallas"``) vs
  ``multilevel_roi_align_ref`` and its geometry helpers, on boxes that stress
  each branch: sqrt-area exactly 112 / 224 / 448, long sides that trigger
  the window-fit bump, boxes routed to the virtual level over an odd top
  level, a box beyond even the virtual level's budget (the window clip),
  zero-size boxes and batch_idx > 0;
- the twin vs the Pallas kernels K1 (``U2SEG_POOL_PREW`` unset) and K2
  (``=0``) run in Pallas interpret mode.

Tolerances: f32 rtol 1e-4 with atol 1e-4 * max|ref|; routing (levels,
window origins) exact. The CUDA kernel itself is held to the twin on the
card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import u2seg_tpu.ops.roi_align_pallas as jrap
from u2seg_tpu.ops.roi_align import multilevel_roi_align as j_gather
from u2seg_torch.ops import roi_align_ml as trap
from u2seg_torch.ops.roi_align import multilevel_roi_align as t_gather

torch.set_num_threads(1)

STRIDES = (4, 8, 16, 32)


def close(got, ref, rtol=1e-4):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    atol = 1e-4 * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def levels(rng, b=2, c=8, h=56, w=88):
    """p2..p5 of a (4h, 4w) image; the top level is 7 x 11 (odd)."""
    return [rng.randn(b, h // 2 ** i, w // 2 ** i, c).astype(np.float32)
            for i in range(4)]


def boundary_boxes():
    return np.array([
        [10.0, 20.0, 122.0, 132.0],     # sqrt-area exactly 112
        [30.0, 5.0, 254.0, 229.0],      # exactly 224
        [0.0, 0.0, 448.0, 448.0],       # exactly 448
        [5.0, 10.0, 345.0, 30.0],       # long side -> window-fit bump
        [40.0, 2.0, 60.0, 220.0],       # tall thin -> bump
        [3.0, 4.0, 1003.0, 964.0],      # over budget at p5 -> virtual level
        [0.0, 0.0, 2000.0, 1900.0],     # over budget even on the virtual level
        [50.0, 50.0, 50.0, 50.0],       # zero size
        [0.0, 0.0, 0.0, 0.0],           # zero box
        [200.0, 120.0, 360.0, 230.0],   # partly outside the image
        [12.5, 7.25, 44.75, 39.5],      # small, fractional
    ], np.float32)


def test_gather_pooler_matches_jax():
    rng = np.random.RandomState(0)
    feats = levels(rng)
    boxes = boundary_boxes()
    bidx = (np.arange(len(boxes)) % 2).astype(np.int32)
    for s in (7, 14):
        ref = j_gather([jnp.asarray(f) for f in feats], jnp.asarray(boxes),
                       jnp.asarray(bidx), s, list(STRIDES), 2)
        got = t_gather([torch.from_numpy(f) for f in feats],
                       torch.from_numpy(boxes), torch.from_numpy(bidx), s,
                       list(STRIDES), 2)
        close(got, ref)


def test_ml_prep_routing_matches_jax():
    rng = np.random.RandomState(1)
    feats = levels(rng)
    boxes = boundary_boxes()
    jf, js = jrap._append_virtual_level([jnp.asarray(f) for f in feats], STRIDES)
    tf, ts = trap._append_virtual_level([torch.from_numpy(f) for f in feats],
                                        STRIDES)
    assert ts == js
    close(tf[-1], jf[-1])
    dims = tuple((f.shape[1], f.shape[2]) for f in jf)
    ref = jrap._ml_prep(jnp.asarray(boxes), dims, js, 7, 2, 224.0, 4)
    got = trap._ml_prep(torch.from_numpy(boxes), dims, ts, 7, 2, 224.0, 4)
    assert got["pdims"] == ref["pdims"]
    for k in ("lvl", "oy", "ox"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    for k in ("y0", "x0", "bin_h", "bin_w"):
        close(got[k], ref[k])
    # every branch is exercised: canonical levels 1..3, a bump, the virtual level
    lvl = got["lvl"].numpy()
    assert {1, 2, 3, 4} <= set(lvl.tolist())
    # the K1 streamed-weight form of the same geometry
    for (c0, bs, org, dim_i, win) in (("y0", "bin_h", "oy", 0, jrap.WIN_Y),
                                      ("x0", "bin_w", "ox", 1, jrap.WIN)):
        size = np.array([dims[l][dim_i] for l in lvl], np.float32)
        ref_w = jrap._pooled_axis_weights_host(
            ref[c0], ref[bs], ref[org], jnp.asarray(size), 7, 2, win)
        got_w = trap._pooled_axis_weights_host(
            got[c0], got[bs], got[org], torch.from_numpy(size), 7, 2, win)
        close(got_w, ref_w)


@pytest.mark.parametrize("s", [7, 14])
def test_twin_matches_ml_ref(s):
    rng = np.random.RandomState(2)
    feats = levels(rng)
    boxes = boundary_boxes()
    bidx = np.array([1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 1], np.int32)
    ref = jrap.multilevel_roi_align_ref(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), jnp.asarray(bidx),
        s, STRIDES, 2)
    args = ([torch.from_numpy(f) for f in feats], torch.from_numpy(boxes),
            torch.from_numpy(bidx), s, STRIDES, 2)
    close(trap.multilevel_roi_align_ref(*args), ref)
    # on CPU tensors the wrapper IS the twin, launches nothing, and emits the
    # requested dtype
    before = trap.multilevel_roi_align_kernel.launches
    out = trap.multilevel_roi_align_kernel(*args, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert trap.multilevel_roi_align_kernel.launches == before
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref),
                               rtol=0.05, atol=0.03)


def test_twin_window_geometry_matches_jax():
    rng = np.random.RandomState(3)
    feats = levels(rng)
    boxes = boundary_boxes()
    bidx = np.array([1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 1], np.int32)
    jf, js = jrap._append_virtual_level([jnp.asarray(f) for f in feats], STRIDES)
    dims = tuple((f.shape[1], f.shape[2]) for f in jf)
    rw = jrap._ml_geometry(jnp.asarray(boxes), jnp.asarray(bidx), dims, js,
                           7, 2, 224.0, 4)
    tw = trap._ml_geometry(torch.from_numpy(boxes), torch.from_numpy(bidx), dims,
                           js, 7, 2, 224.0, 4)
    close(tw[0], rw[0])
    close(tw[1], rw[1])
    np.testing.assert_array_equal(tw[2].numpy(), np.asarray(rw[2]))
    assert tw[4] == rw[4]


@pytest.fixture
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    jax.clear_caches()
    yield monkeypatch
    jax.clear_caches()


@pytest.mark.parametrize("prew", ["unset", "0"])
def test_twin_matches_pallas_kernels_interpret(interpret_mode, prew):
    """K1 (streamed weights, the default) and K2 (in-kernel weights) in
    Pallas interpret mode vs the port's twin, at <= 8 ROIs."""
    if prew == "unset":
        interpret_mode.delenv("U2SEG_POOL_PREW", raising=False)
    else:
        interpret_mode.setenv("U2SEG_POOL_PREW", prew)
    rng = np.random.RandomState(4)
    feats = levels(rng)
    boxes = boundary_boxes()[[0, 1, 3, 5, 7, 9, 10]]
    bidx = np.array([1, 0, 1, 0, 1, 1, 0], np.int32)
    ref = jrap.multilevel_roi_align_pallas(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), jnp.asarray(bidx),
        7, STRIDES, 2)
    got = trap.multilevel_roi_align_ref(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes),
        torch.from_numpy(bidx), 7, STRIDES, 2)
    close(got, ref)


def test_single_level_roi_align_matches_jax():
    from u2seg_tpu.ops.roi_align import roi_align as jra
    from u2seg_torch.ops.roi_align import roi_align as tra

    rng = np.random.RandomState(5)
    feat = rng.randn(2, 30, 42, 8).astype(np.float32)
    boxes = boundary_boxes()[[0, 3, 7, 9, 10]] / 4.0
    bidx = np.array([0, 1, 1, 0, 1], np.int32)
    ref = jra(jnp.asarray(feat), jnp.asarray(boxes), jnp.asarray(bidx), 7, 0.25, 2)
    got = tra(torch.from_numpy(feat), torch.from_numpy(boxes),
              torch.from_numpy(bidx), 7, 0.25, 2)
    close(got, ref)
