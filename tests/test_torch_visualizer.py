"""The OpenCV-free visualizer (``u2seg_torch/utils/visualizer.py`` over
``utils/raster.py``) against the JAX package's, which draws with ``cv2``.

Exact: every pixel outside the labels' text boxes (``cv2.getTextSize`` at
the JAX call's origin; the port reports the boxes it drew in) equals the JAX
``Visualizer``'s: mask blends, boxes (``cv2.rectangle``, thickness 2),
keypoint dots (``cv2.circle``, filled, radius 3), limbs (``cv2.line``),
panoptic and semantic segments, dataset dicts and the ``VideoVisualizer``.
The primitives alone equal ``cv2`` on every pixel over seeded random cases,
endpoints outside the image included.

Text: Hershey glyphs have no twin without OpenCV. The port's label lies
inside the box that ``cv2.getTextSize`` gives, as cv2's own does; inside
it, the port writes the text color or leaves the pixel, and at most 60% of
the box's pixels differ from cv2's anti-aliased label (measured 34-58% on
these strings; the most where narrow characters such as "ill" overlap).
"""
import cv2
import numpy as np
import pytest

from u2seg_tpu.utils import visualizer as jvis
from u2seg_torch.utils import raster
from u2seg_torch.utils import visualizer as tvis

TEXT_DIFF_BOUND = 0.6


def outside_text(shape, boxes):
    keep = np.ones(shape[:2], bool)
    for x0, y0, x1, y1 in boxes:
        keep[max(y0, 0):max(y1 + 1, 0), max(x0, 0):max(x1 + 1, 0)] = False
    return keep


def assert_equal_outside_text(got, ref, boxes):
    keep = outside_text(ref.shape, boxes)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    bad = np.argwhere((got != ref).any(-1) & keep)
    assert len(bad) == 0, bad[:10]
    assert keep.mean() > 0.5


def image(rng, h=120, w=160):
    return (rng.rand(h, w, 3) * 255).astype(np.uint8)


class Meta:
    thing_classes = ["person", "car", "dog", "pizza"]
    stuff_classes = ["things", "sky", "grass", "road", "wall"]


@pytest.mark.parametrize("seed", range(4))
def test_instance_predictions_equal_the_jax_visualizer(seed):
    rng = np.random.RandomState(seed)
    img = image(rng)
    k = 6
    xy = rng.rand(k, 2) * [190, 150] - 15               # some boxes leave the image
    boxes = np.concatenate([xy, xy + rng.rand(k, 2) * 90], 1)
    boxes[0] = [30.7, 40.2, 30.7, 80.9]                 # zero width
    kp = np.concatenate([rng.rand(k, 17, 2) * [200, 160] - 20, rng.rand(k, 17, 1)], -1)
    inst = {"boxes": boxes, "scores": rng.rand(k), "classes": rng.randint(0, 300, k),
            "masks": [rng.rand(120, 160) > 0.6 for _ in range(k)], "keypoints": kp}
    ref = jvis.Visualizer(img, Meta()).draw_instance_predictions(inst)
    v = tvis.Visualizer(img, Meta())
    got = v.draw_instance_predictions(inst)
    assert len(v.text_boxes) == k
    assert_equal_outside_text(got, ref, v.text_boxes)


def test_panoptic_semantic_and_dataset_dicts_equal_the_jax_visualizer():
    rng = np.random.RandomState(5)
    img = image(rng)
    pan = np.zeros((120, 160), np.int32)
    pan[:60] = 1
    pan[60:, :80] = 2
    pan[20:50, 30:70] = 3
    pan[70:110, 90:150] = 4
    segments = [{"id": 1, "category_id": 1, "isthing": False},
                {"id": 2, "category_id": 3, "isthing": False},
                {"id": 3, "category_id": 0, "isthing": True},
                {"id": 4, "category_id": 2, "isthing": True},
                {"id": 9, "category_id": 2, "isthing": True}]      # no pixel: skipped
    ref = jvis.Visualizer(img, Meta()).draw_panoptic_seg(pan, segments)
    v = tvis.Visualizer(img, Meta())
    assert_equal_outside_text(v.draw_panoptic_seg(pan, segments), ref, v.text_boxes)
    assert len(v.text_boxes) == 4

    sem = rng.randint(0, 5, (120, 160))
    sem[:10] = 255
    np.testing.assert_array_equal(tvis.Visualizer(img).draw_sem_seg(sem),
                                  jvis.Visualizer(img).draw_sem_seg(sem))

    d = {"annotations": [{"bbox": [10.5, 12.0, 50.0, 40.0], "category_id": 1},
                         {"bbox": [80.0, 60.0, 70.0, 70.0], "category_id": 3}]}
    ref = jvis.Visualizer(img, Meta()).draw_dataset_dict(d)
    v = tvis.Visualizer(img, Meta())
    assert_equal_outside_text(v.draw_dataset_dict(d), ref, v.text_boxes)


def test_video_visualizer_colors_follow_track_ids_as_the_jax_one():
    rng = np.random.RandomState(6)
    img = image(rng)
    inst = {"boxes": np.array([[5, 20, 60, 90], [70, 30, 150, 110]], np.float64),
            "scores": np.array([0.91, 0.33]), "classes": np.array([0, 2]),
            "masks": [rng.rand(120, 160) > 0.5 for _ in range(2)]}
    for ids in (np.array([17, 1023]), None):
        ref = jvis.VideoVisualizer(Meta()).draw_instance_predictions(img, inst, ids)
        vv = tvis.VideoVisualizer(Meta())
        got = vv.draw_instance_predictions(img, inst, ids)
        assert_equal_outside_text(got, ref, vv.text_boxes)
    np.testing.assert_array_equal(tvis.colormap(1024), jvis.colormap(1024))


@pytest.mark.parametrize("seed", range(3))
def test_raster_primitives_equal_cv2(seed):
    rng = np.random.RandomState(100 + seed)
    for _ in range(300):
        h, w = rng.randint(5, 60, 2)
        p1 = tuple(int(v) for v in rng.randint(-15, 75, 2))
        p2 = tuple(int(v) for v in rng.randint(-15, 75, 2))
        color = tuple(int(v) for v in rng.randint(1, 256, 3))
        for draw_cv, draw_port in (
                (lambda a: cv2.rectangle(a, p1, p2, color, 2),
                 lambda a: raster.rectangle(a, p1, p2, color, 2)),
                (lambda a: cv2.line(a, p1, p2, color, 1),
                 lambda a: raster.line(a, p1, p2, color)),
                (lambda a: cv2.circle(a, p1, 3, color, -1),
                 lambda a: raster.circle_filled(a, p1, 3, color))):
            a = np.zeros((h, w, 3), np.uint8)
            b = a.copy()
            draw_cv(a)
            draw_port(b)
            np.testing.assert_array_equal(b, a)


STRINGS = ["person 87%", "gjpqy_ 12% #3", "ill", "A", "car 100% #1023", "{[(|)]}",
           "The quick brown fox, 42.5%", "~`!@$^&*-=+;:'\"<>?/\\"]


@pytest.mark.parametrize("text", STRINGS)
def test_labels_stay_in_the_cv2_text_box(text):
    (w, h), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
    assert raster.text_size(text) == ((w, h), base)
    rng = np.random.RandomState(len(text))
    bg = image(rng, 40, 320)
    org = (7, 22)
    ref = bg.copy()
    cv2.putText(ref, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1,
                cv2.LINE_AA)
    got = bg.copy()
    raster.put_text(got, text, org, np.array([255, 255, 255], np.uint8))
    box = raster.text_box(text, org)
    keep = outside_text(bg.shape, [box])
    np.testing.assert_array_equal(ref[keep], bg[keep])       # cv2 stays inside too
    np.testing.assert_array_equal(got[keep], bg[keep])
    inside = ~keep
    changed = (got != bg).any(-1) & inside
    assert changed.any() or not text.strip()
    assert (got[changed] == 255).all()
    assert ((got != ref).any(-1) & inside).sum() <= TEXT_DIFF_BOUND * inside.sum()


def test_text_origin_is_clamped_as_in_the_jax_call():
    img = np.zeros((40, 80, 3), np.uint8)
    v = tvis.Visualizer(img)
    v._draw_text("dog", (3.9, -30.0))
    assert v.text_boxes == [raster.text_box("dog", (3, 10))]
