"""The last public functions of the JAX package's structures and ops against
their port counterparts on the same numpy inputs: ``structures/boxes.py``'s
``convert_mode``, ``centers``, ``scale``, ``pairwise_ioa``,
``matched_pairwise_iou`` and ``pairwise_point_box_distance``,
``structures/instances.py::pad_to`` and ``ops/mask_paste.py::paste_masks_scaled``.

Tolerances (f32): sums, differences and products exactly; the quotients of
``pairwise_ioa`` and ``matched_pairwise_iou`` to rtol 1e-6; the pasted masks
(two matmuls) to atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2seg_tpu.ops import mask_paste as jpaste
from u2seg_tpu.structures import boxes as jboxes
from u2seg_tpu.structures import instances as jinst
from u2seg_torch.ops import mask_paste
from u2seg_torch.structures import boxes, instances


def random_boxes(rng, n, size=100.0):
    xy = rng.rand(n, 2) * size
    wh = rng.rand(n, 2) * size / 2
    b = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    b[0, 2:] = b[0, :2]                          # an empty box
    return b


def both(fn_t, fn_j, *arrays, **kw):
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **kw).numpy()
    ref = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays), **kw))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    return got, ref


@pytest.mark.parametrize("modes", [(boxes.XYXY_ABS, boxes.XYWH_ABS),
                                   (boxes.XYWH_ABS, boxes.XYXY_ABS),
                                   (boxes.XYXY_ABS, boxes.XYXY_ABS)])
def test_convert_mode_matches_jax(rng, modes):
    assert (boxes.XYXY_ABS, boxes.XYWH_ABS) == (jboxes.XYXY_ABS, jboxes.XYWH_ABS)
    b = random_boxes(rng, 9).reshape(3, 3, 4)
    got, ref = both(boxes.convert_mode, jboxes.convert_mode, b,
                    from_mode=modes[0], to_mode=modes[1])
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        boxes.convert_mode(torch.from_numpy(b), 0, 4)


def test_centers_and_scale_match_jax(rng):
    b = random_boxes(rng, 11)
    got, ref = both(boxes.centers, jboxes.centers, b)
    np.testing.assert_array_equal(got, ref)
    got, ref = both(boxes.scale, jboxes.scale, b, scale_x=0.37, scale_y=2.5)
    np.testing.assert_array_equal(got, ref)


def test_pairwise_ioa_and_matched_iou_match_jax(rng):
    b1, b2 = random_boxes(rng, 7), random_boxes(rng, 5)
    got, ref = both(boxes.pairwise_ioa, jboxes.pairwise_ioa, b1, b2)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert (got[:, 0] == 0).all()                 # empty boxes2[0]: zero, not NaN
    b3 = random_boxes(rng, 7)
    got, ref = both(boxes.matched_pairwise_iou, jboxes.matched_pairwise_iou, b1, b3)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert got[0] == 0 and (got >= 0).all() and (got <= 1).all()


def test_pairwise_point_box_distance_matches_jax(rng):
    points = (rng.rand(13, 2) * 100).astype(np.float32)
    got, ref = both(boxes.pairwise_point_box_distance, jboxes.pairwise_point_box_distance,
                    points, random_boxes(rng, 6))
    assert got.shape == (13, 6, 4)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n,axis,value", [(7, 0, 0), (3, 0, 0), (5, 0, 0),
                                          (9, 1, -1), (2, 1, 0), (6, -1, 255)])
def test_pad_to_matches_jax(rng, n, axis, value):
    x = rng.randint(0, 50, (5, 4, 3)).astype(np.int32)
    got, ref = both(instances.pad_to, jinst.pad_to, x, n=n, axis=axis, value=value)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("stride", [1, 4])
def test_paste_masks_scaled_matches_jax(rng, stride):
    masks = rng.rand(4, 28, 28).astype(np.float32)
    b = random_boxes(rng, 4, size=160.0)
    got, ref = both(mask_paste.paste_masks_scaled, jpaste.paste_masks_scaled, masks, b,
                    out_h=48, out_w=40, stride=stride)
    assert got.shape == (4, 48, 40)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
