"""The plain version of the ROIAlign backward kernel vs the JAX package.

The port's backward kernel (CUDA) is held on the card against autograd of
``multilevel_roi_align_ref``; here that plain version is held against the JAX
package on the CPU, two ways:

(a) ``jax.grad`` of the JAX ``multilevel_roi_align_ref`` w.r.t. the real
    levels (the virtual level's gradient arrives through the 2x average
    pool);
(b) ``_ml_bwd_features``, the JAX package's plain reference of its Pallas
    backward kernel, w.r.t. the EXTENDED level list (virtual level last).

Tolerance: f32, 1e-5 * max|grad| per level (the sums run in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2seg_tpu.ops import roi_align_pallas as jrap
from u2seg_torch.ops import roi_align_ml as rap

torch.set_num_threads(1)
STRIDES = (4, 8, 16, 32)
H, W, C, B = 96, 160, 6, 2          # p5 is 3 x 5: narrower than the window


def _levels(rng, dtype=np.float32):
    return [rng.randn(B, H // s, W // s, C).astype(dtype) for s in STRIDES]


BOXES = {
    "small": [[3.0, 5.0, 20.0, 30.0], [40.5, 12.25, 47.0, 19.5],
              [100.0, 60.0, 131.0, 90.0], [0.0, 0.0, 9.0, 7.0]],
    # SPAN_BUDGET = 28 cells: 112 px on p2, 224 on p3 -> the window-fit bump
    "budget_edge": [[4.0, 4.0, 116.0, 60.0], [4.0, 4.0, 117.0, 60.0],
                    [10.0, 2.0, 30.0, 95.0], [1.0, 1.0, 158.0, 20.0]],
    # over the budget on p5 (896 px) -> the virtual level
    "virtual": [[0.0, 0.0, 900.0, 950.0], [-300.0, -200.0, 700.0, 760.0],
                [0.0, 0.0, 2000.0, 1900.0]],
    "degenerate": [[50.0, 50.0, 50.0, 50.0], [0.0, 0.0, 0.0, 0.0],
                   [150.0, 80.0, 200.0, 120.0], [-40.0, -30.0, -5.0, -2.0]],
}


def _case(name, s):
    rng = np.random.RandomState(sorted(BOXES).index(name) + 10 * s)
    boxes = np.array(BOXES[name], np.float32)
    bidx = rng.randint(0, B, len(boxes)).astype(np.int32)
    g = rng.randn(len(boxes), s, s, C).astype(np.float32)
    return _levels(rng), boxes, bidx, g


def _close(got, ref, what):
    ref = np.asarray(ref)
    tol = 1e-5 * max(float(np.abs(ref).max()), 1e-30)
    assert got.shape == ref.shape, what
    assert float(np.abs(got.detach().numpy() - ref).max()) <= tol, what


@pytest.mark.parametrize("s", [7, 14])
@pytest.mark.parametrize("name", sorted(BOXES))
def test_autograd_of_plain_version_matches_jax_grad(name, s):
    levels, boxes, bidx, g = _case(name, s)
    ref = jax.grad(lambda f: (jrap.multilevel_roi_align_ref(
        f, jnp.asarray(boxes), jnp.asarray(bidx), s, STRIDES) * g).sum())(
            [jnp.asarray(l) for l in levels])
    feats = [torch.from_numpy(l).requires_grad_() for l in levels]
    out = rap.multilevel_roi_align_train(
        feats, torch.from_numpy(boxes), torch.from_numpy(bidx), s, STRIDES)
    assert out.dtype == torch.float32
    got = torch.autograd.grad(out, feats, torch.from_numpy(g))
    if name == "virtual":
        assert float(got[3].abs().max()) > 0 and float(got[0].abs().max()) == 0
    for lvl, (a, b) in enumerate(zip(got, ref)):
        _close(a, b, f"{name} s={s} level {lvl}")


@pytest.mark.parametrize("s", [7, 14])
@pytest.mark.parametrize("name", sorted(BOXES))
def test_autograd_of_plain_version_matches_ml_bwd_features(name, s):
    levels, boxes, bidx, g = _case(name, s)
    jext, jstrides = jrap._append_virtual_level(
        [jnp.asarray(l) for l in levels], STRIDES)
    ref = jrap._ml_bwd_features(
        jnp.asarray(g), jnp.asarray(boxes), jnp.asarray(bidx),
        tuple(tuple(f.shape) for f in jext), jnp.float32, s, tuple(jstrides),
        2, 224.0, 4)
    ext, strides = rap._append_virtual_level(
        [torch.from_numpy(l) for l in levels], STRIDES)
    for a, b in zip(ext, jext):                      # the virtual level itself
        _close(a, b, "virtual level")
    ext = [f.detach().requires_grad_() for f in ext]
    out = rap._ref_ext(ext, torch.from_numpy(boxes), torch.from_numpy(bidx),
                       s, strides, 2, 224.0, 4)
    got = torch.autograd.grad(out, ext, torch.from_numpy(g), allow_unused=True)
    assert len(got) == len(ref) == 5
    for lvl, (a, b) in enumerate(zip(got, ref)):
        _close(a, b, f"{name} s={s} extended level {lvl}")
    if name == "virtual":
        assert float(got[4].abs().max()) > 0


def test_bf16_levels_get_bf16_gradients_and_f32_output():
    levels, boxes, bidx, g = _case("small", 7)
    feats = [torch.from_numpy(l).bfloat16().requires_grad_() for l in levels]
    out = rap.multilevel_roi_align_train(
        feats, torch.from_numpy(boxes), torch.from_numpy(bidx), 7, STRIDES)
    assert out.dtype == torch.float32
    got = torch.autograd.grad(out, feats, torch.from_numpy(g))
    assert all(t.dtype == torch.bfloat16 and t.shape == f.shape
               for t, f in zip(got, feats))
    ref = jrap._ml_bwd_features(
        jnp.asarray(g), jnp.asarray(boxes), jnp.asarray(bidx),
        tuple(tuple(f.shape) for f in jrap._append_virtual_level(
            [jnp.asarray(l) for l in levels], STRIDES)[0]),
        jnp.float32, 7, STRIDES + (64,), 2, 224.0, 4)
    # one bf16 rounding of an f32 sum: 2^-8 relative
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b), rtol=0.01,
                                   atol=0.01 * float(np.abs(b).max()))


def test_no_rois_gives_zero_gradients():
    levels, boxes, bidx, g = _case("small", 7)
    feats = [torch.from_numpy(l).requires_grad_() for l in levels]
    out = rap.multilevel_roi_align_train(
        feats, torch.from_numpy(boxes[:0]), torch.from_numpy(bidx[:0]), 7, STRIDES)
    assert out.shape == (0, 7, 7, C)
    got = torch.autograd.grad(out, feats, torch.from_numpy(g[:0]))
    assert all(float(t.abs().max()) == 0 for t in got)


def test_gradient_reaches_channels_last_nchw_maps():
    """The model hands the pooler NHWC views of NCHW channels-last maps; the
    gradient must come back on the NCHW leaf."""
    levels, boxes, bidx, g = _case("small", 7)
    leaves = [torch.from_numpy(l).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_() for l in levels]
    views = [t.permute(0, 2, 3, 1) for t in leaves]
    assert all(v.is_contiguous() for v in views)
    out = rap.multilevel_roi_align_train(
        views, torch.from_numpy(boxes), torch.from_numpy(bidx), 7, STRIDES)
    (out * torch.from_numpy(g)).sum().backward()
    feats = [torch.from_numpy(l).requires_grad_() for l in levels]
    ref = torch.autograd.grad(rap.multilevel_roi_align_ref(
        feats, torch.from_numpy(boxes), torch.from_numpy(bidx), 7, STRIDES),
        feats, torch.from_numpy(g))
    for leaf, r in zip(leaves, ref):
        assert leaf.grad.shape == leaf.shape
        _close(leaf.grad.permute(0, 2, 3, 1), r.numpy(), "nchw leaf")
