"""u2seg_torch.ops.roi_align_single (the port of the single-level window
ROIAlign kernel) on the CPU: its plain version and the kernel's dense form
(``Wy @ window @ Wx^T`` with the tables of ``pooled_axis_weights``, r-sample
mean folded in) vs the JAX package's ``roi_align_pallas`` run in interpret
mode, and vs the port's gather pooler.

Tolerances: f32 1e-4 (rtol and atol): both sides evaluate the same two
weight products in f32, in other summation orders. Against the gather
pooler only boxes that fit the 40 x 40 window are compared: a longer box
loses its far samples in the window kernel, by design.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import u2seg_tpu.ops.roi_align_pallas as jrap
from u2seg_torch.ops.roi_align import roi_align
from u2seg_torch.ops.roi_align_single import (
    WIN, pooled_axis_weights, roi_align_single, roi_align_single_ref)

torch.set_num_threads(1)

# the JAX package's own test boxes (scale 1/4 on a 64 x 64 map), then: a box
# longer than the window (56 > 40 cells), two degenerate zero boxes, a box
# past the map's corner, a small fractional one, one at the far corner where
# the origin clip engages
BOXES = np.array([
    [8.0, 8.0, 120.0, 100.0],
    [0.0, 0.0, 60.0, 60.0],
    [100.0, 100.0, 200.0, 220.0],
    [4.0, 16.0, 228.0, 240.0],
    [0.0, 0.0, 0.0, 0.0],
    [50.0, 50.0, 50.0, 50.0],
    [200.0, 180.0, 300.0, 290.0],
    [12.5, 7.25, 44.75, 39.5],
    [150.0, 160.0, 255.0, 250.0],
], np.float32)
BIDX = np.array([0, 1, 0, 1, 0, 1, 0, 1, 0], np.int32)
FITS = [0, 1, 2, 4, 5, 6, 7, 8]      # all but the over-long box


@pytest.fixture
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


@pytest.fixture(scope="module")
def feat():
    return np.random.RandomState(0).randn(2, 64, 64, 8).astype(np.float32)


def dense_pool(feat, boxes, bidx, s, r, scale):
    """``Wy @ window @ Wx^T`` per ROI, from the kernel's dense tables."""
    _, h, w, _ = feat.shape
    wy, wx, origin = pooled_axis_weights(boxes, h, w, s, r, scale)
    cells = torch.arange(WIN)
    rows = origin[:, 0].long()[:, None] + cells
    cols = origin[:, 1].long()[:, None] + cells
    window = feat[bidx.long()[:, None, None], rows[:, :, None], cols[:, None, :]]
    return torch.einsum("rpy,rqx,ryxc->rpqc", wy, wx, window.to(torch.float32))


@pytest.mark.parametrize("s,r", [(7, 2), (4, 0), (14, 2)])
def test_plain_version_matches_the_pallas_kernel(interpret_mode, feat, s, r):
    ref = np.asarray(jrap.roi_align_pallas(
        jnp.asarray(feat), jnp.asarray(BOXES), jnp.asarray(BIDX), s, 0.25, r))
    args = torch.from_numpy(feat), torch.from_numpy(BOXES), torch.from_numpy(BIDX)
    got = roi_align_single_ref(*args, s, 0.25, r)
    assert got.shape == ref.shape == (len(BOXES), s, s, 8)
    assert got.dtype == torch.float32 and np.isfinite(ref).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    # the kernel's dense form pools the same
    dense = dense_pool(*args, s, r if r > 0 else 2, 0.25).numpy()
    np.testing.assert_allclose(dense, ref, rtol=1e-4, atol=1e-4)
    # the over-long box really lost samples: its last output row is empty
    assert np.abs(ref[3, -1]).max() == 0 and np.abs(ref[3, 0]).max() > 0
    assert np.abs(dense[3, -1]).max() == 0


def test_wrapper_takes_the_plain_version_on_cpu_tensors(feat):
    args = (torch.from_numpy(feat), torch.from_numpy(BOXES),
            torch.from_numpy(BIDX), 7, 0.25, 2)
    before = roi_align_single.launches
    assert torch.equal(roi_align_single(*args), roi_align_single_ref(*args))
    assert roi_align_single.launches == before      # no kernel was launched


def test_matches_the_gather_pooler_on_boxes_that_fit(feat):
    f, boxes, bidx = (torch.from_numpy(feat), torch.from_numpy(BOXES[FITS]),
                      torch.from_numpy(BIDX[FITS]))
    got = roi_align_single(f, boxes, bidx, 7, 0.25, 2)
    ref = roi_align(f, boxes, bidx, 7, 0.25, 2)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


def test_bf16_map_gives_f32_output_and_no_rois_an_empty_one(feat):
    f = torch.from_numpy(feat).to(torch.bfloat16)
    boxes, bidx = torch.from_numpy(BOXES), torch.from_numpy(BIDX)
    got = roi_align_single(f, boxes, bidx, 7, 0.25, 2)
    assert got.dtype == torch.float32
    ref = roi_align_single(f.float(), boxes, bidx, 7, 0.25, 2)
    assert torch.equal(got, ref)      # the window is cast up before the products
    assert roi_align_single(f, boxes[:0], bidx[:0], 7, 0.25, 2).shape == (0, 7, 7, 8)


def test_maps_smaller_than_the_window_raise():
    f = torch.zeros(1, WIN - 1, 64, 8)
    with pytest.raises(ValueError, match="smaller than"):
        roi_align_single(f, torch.zeros(1, 4), torch.zeros(1, dtype=torch.int32),
                         7, 0.25, 2)
