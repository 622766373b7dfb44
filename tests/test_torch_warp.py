"""``u2seg_torch/data/warp.py`` against OpenCV, and the port's rotation and
extent transforms against the JAX package's (which call OpenCV).

Tolerances: uint8 images bit for bit; f32 images 1e-4 absolute on 0..255
values (they come out equal); matrices and points bit for bit (f64).
"""
import cv2
import numpy as np
import pytest
import torch

from u2seg_tpu.config.config import Config as JConfig
from u2seg_tpu.data import transforms as JT
from u2seg_torch.config import Config
from u2seg_torch.data import transforms as T
from u2seg_torch.data import warp

torch.set_num_threads(1)

ODD_SIZES = [(37, 53), (61, 40), (5, 97), (1, 17), (23, 16), (48, 33)]
F32_TOL = 1e-4


def _image(rng, h, w, kind, channels=3):
    if kind == "u8":
        img = rng.randint(0, 256, (h, w, channels)).astype(np.uint8)
    else:
        img = rng.uniform(0, 255, (h, w, channels)).astype(np.float32)
    return img[..., 0] if channels == 1 else img


def _same(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if ref.dtype == np.uint8:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL)


def _matrix(kind, h, w, rng):
    if kind == "shear":
        return np.array([[1, rng.uniform(-0.3, 0.3), 0], [rng.uniform(-0.3, 0.3), 1, 0]])
    if kind == "translate":
        return np.array([[1, 0, rng.uniform(-0.3, 0.3) * w], [0, 1, rng.uniform(-3, 3)]])
    if kind == "scale":
        return np.array([[rng.uniform(0.5, 2), 0, rng.uniform(-5, 5)],
                         [0, rng.uniform(0.5, 2), rng.uniform(-5, 5)]])
    return cv2.getRotationMatrix2D((w / 2, h / 2), kind, 1.0)


@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("kind", [0, 90, 30, -17.5, "shear", "translate", "scale"])
def test_warp_affine_equals_cv2(kind, interp):
    flag = cv2.INTER_LINEAR if interp == "linear" else cv2.INTER_NEAREST
    rng = np.random.RandomState(len(str(kind)) + 7 * (interp == "linear"))
    for i, (h, w) in enumerate(ODD_SIZES):
        m = _matrix(kind, h, w, rng)
        # output sizes around the input's: the vector / scalar split of a row
        # falls at other columns
        dsize = (w + (i * 7) % 19, h + i % 3)
        for img_kind in ("u8", "f32"):
            for channels in (1, 3):
                for border in (0, 128):
                    img = _image(rng, h, w, img_kind, channels)
                    ref = cv2.warpAffine(img, m, dsize, flags=flag,
                                         borderMode=cv2.BORDER_CONSTANT,
                                         borderValue=(border,) * 4)
                    _same(warp.warp_affine(img, m, dsize, interp, border), ref)


def test_warp_affine_full_size_image_and_a_float32_matrix():
    rng = np.random.RandomState(1)
    img = _image(rng, 427, 640, "u8")
    for m in (cv2.getRotationMatrix2D((320, 213.5), 12.25, 1.0),
              np.array([[1, 0.21, -4], [0, 1, 0]], np.float32)):
        for interp, flag in (("linear", cv2.INTER_LINEAR), ("nearest", cv2.INTER_NEAREST)):
            ref = cv2.warpAffine(img, m, (700, 400), flags=flag, borderValue=(128,) * 4)
            _same(warp.warp_affine(img, m, (700, 400), interp, 128), ref)


def test_warp_affine_keeps_the_dtype_of_a_nearest_label_map():
    rng = np.random.RandomState(2)
    seg = rng.randint(0, 30, (41, 29)).astype(np.int32)
    m = cv2.getRotationMatrix2D((14.5, 20.5), 33.0, 1.0)
    ref = cv2.warpAffine(seg, m, (35, 45), flags=cv2.INTER_NEAREST)
    got = warp.warp_affine(seg, m, (35, 45), "nearest", 0)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hw", ODD_SIZES + [(1, 1), (2, 2), (9, 1)])
def test_blur3x3_equals_cv2(hw):
    rng = np.random.RandomState(hw[0] * 100 + hw[1])
    for channels in (1, 3):
        img = _image(rng, *hw, "u8", channels)
        np.testing.assert_array_equal(warp.blur3x3(img), cv2.blur(img, (3, 3)))


def test_rotation_matrix_and_transform_equal_cv2():
    rng = np.random.RandomState(3)
    for angle in (0, 90, 30, -17.5, 180, *rng.uniform(-180, 180, 20)):
        center = tuple(rng.uniform(0, 500, 2))
        scale = float(rng.choice([1.0, rng.uniform(0.5, 2)]))
        m = cv2.getRotationMatrix2D(center, float(angle), scale)
        np.testing.assert_array_equal(
            warp.get_rotation_matrix_2d(center, float(angle), scale), m)
        pts = rng.uniform(-100, 900, (int(rng.randint(1, 60)), 1, 2))
        if angle == 90:
            pts = np.round(pts * 2) / 2
        np.testing.assert_array_equal(warp.transform(pts, m), cv2.transform(pts, m))
    # the diagonal path (off-diagonals within DBL_EPSILON)
    m = np.array([[1.5, 1e-17, 3.25], [0.0, 0.75, -2.0]])
    pts = rng.uniform(-100, 900, (33, 1, 2))
    np.testing.assert_array_equal(warp.transform(pts, m), cv2.transform(pts, m))


def _polygons(rng, h, w):
    return [rng.rand(int(rng.randint(3, 9)), 2) * [w, h] for _ in range(3)]


def _corner_boxes(jt, boxes):
    """detectron2's box rule (the bounding box of the four mapped corners) on
    the JAX transform's own coordinate map."""
    c = jt.apply_coords(boxes[:, [0, 1, 2, 1, 0, 3, 2, 3]].reshape(-1, 2).astype(np.float64))
    c = c.reshape(-1, 4, 2)
    return np.concatenate([c.min(axis=1), c.max(axis=1)], axis=1)


def _same_transform(t, jt, rng, h, w):
    """Images (uint8 and f32), boxes through corners, coords, polygon points
    and segmentation of a port transform against the JAX one. Boxes: the four
    corners through the JAX map; for an axis-aligned transform that is the
    JAX package's own two-corner box."""
    for kind in ("u8", "f32"):
        img = _image(rng, h, w, kind)
        _same(t.apply_image(img), jt.apply_image(img))
    boxes = np.concatenate([rng.rand(6, 2) * [w / 2, h / 2],
                            rng.rand(6, 2) * [w / 2, h / 2] + [w / 2, h / 2]], 1)
    np.testing.assert_array_equal(t.apply_box(boxes), _corner_boxes(jt, boxes))
    if not isinstance(jt, JT.RotationTransform) or jt.angle % 360 == 0:
        np.testing.assert_array_equal(t.apply_box(boxes), jt.apply_box(boxes))
    coords = rng.rand(9, 2) * [w, h]
    np.testing.assert_array_equal(t.apply_coords(coords.copy()), jt.apply_coords(coords.copy()))
    for p in _polygons(rng, h, w):                  # polygon points: the coords path
        np.testing.assert_array_equal(t.apply_coords(p.copy()), jt.apply_coords(p.copy()))
    seg = rng.randint(0, 28, (h, w)).astype(np.uint8)
    _same(t.apply_segmentation(seg), jt.apply_segmentation(seg))


@pytest.mark.parametrize("case", ["expand", "no_expand", "center", "right_angle", "full_turn"])
def test_rotation_transform_matches_jax(case):
    rng = np.random.RandomState(len(case))
    for h, w in ODD_SIZES[:4] + [(427, 640)]:
        angle = {"right_angle": 90.0, "full_turn": 360.0}.get(case, rng.uniform(-45, 45))
        kw = {"expand": case != "no_expand"}
        if case == "center":
            kw["center"] = (w * 0.3, h * 0.7)
        _same_transform(T.RotationTransform(h, w, angle, **kw),
                        JT.RotationTransform(h, w, angle, **kw), rng, h, w)


def test_a_rotated_box_bounds_its_four_corners_where_the_jax_package_maps_two():
    # the JAX base transform maps the corners (x0, y0) and (x1, y1) only: at
    # 45 degrees a square's diagonal turns level and its box collapses
    box = np.array([[10.0, 10.0, 30.0, 30.0]])
    t, jt = T.RotationTransform(40, 40, 45.0), JT.RotationTransform(40, 40, 45.0)
    got, ref = t.apply_box(box)[0], jt.apply_box(box)[0]
    assert ref[3] - ref[1] < 1e-9                               # the JAX box: zero high
    np.testing.assert_allclose(got[2:] - got[:2], [20 * np.sqrt(2)] * 2, rtol=1e-12)
    np.testing.assert_array_equal(got, _corner_boxes(jt, box)[0])


@pytest.mark.parametrize("rect", [(0.0, 0.0, 1.0, 1.0), (-0.2, 0.1, 0.9, 1.3), (0.25, 0.3, 0.6, 0.55)])
def test_extent_transform_matches_jax(rect):
    rng = np.random.RandomState(int(rect[2] * 10))
    for h, w in ODD_SIZES[:4]:
        src = (rect[0] * w, rect[1] * h, rect[2] * w, rect[3] * h)
        out = (int(round((rect[3] - rect[1]) * h)) + 1, int(round((rect[2] - rect[0]) * w)) + 2)
        _same_transform(T.ExtentTransform(src, out), JT.ExtentTransform(src, out), rng, h, w)


@pytest.mark.parametrize("aug", ["rotation_range", "rotation_choice", "rotation_center", "extent"])
def test_random_rotation_and_extent_draw_like_jax(aug):
    def build(mod):
        if aug == "rotation_range":
            return mod.RandomRotation([-30.0, 30.0])
        if aug == "rotation_choice":
            return mod.RandomRotation([0.0, 90.0, -17.5], expand=False, sample_style="choice")
        if aug == "rotation_center":
            return mod.RandomRotation([-20.0, 20.0], center=[[0.2, 0.3], [0.8, 0.6]])
        return mod.RandomExtent((0.7, 1.3), (0.2, 0.2))

    a, ja = build(T), build(JT)
    for seed in range(8):
        rng = np.random.RandomState(seed)
        h, w = ODD_SIZES[seed % 4]
        img = _image(rng, h, w, "u8")
        r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
        t, jt = a.get_transform(img, r1), ja.get_transform(img, r2)
        assert type(t).__name__ == type(jt).__name__
        assert r1.rand() == r2.rand()                      # the same draws
        _same_transform(t, jt, rng, h, w)


def test_build_augmentation_with_rotation_draws_the_same_angles():
    cfg, jcfg = Config(), JConfig()
    for c in (cfg, jcfg):
        c.input.rotation_enabled = True
        c.input.min_size_train = (64, 72, 80)
        c.input.max_size_train = 133
    augs = T.build_augmentation(cfg.input, True)
    jaugs = JT.build_augmentation(jcfg.input, True)
    rot = [a for a in augs.augs if isinstance(a, T.RandomRotation)]
    assert len(rot) == 1 and rot[0].angle == [-30.0, 30.0] and rot[0].expand
    for seed in range(6):
        rng = np.random.RandomState(seed)
        h, w = ODD_SIZES[seed % 4][0] + 40, ODD_SIZES[seed % 4][1] + 40
        img = _image(rng, h, w, "u8")
        seg = rng.randint(0, 28, (h, w)).astype(np.uint8)
        r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
        t = augs.get_transform(img, r1, sem_seg=seg.copy())
        jt = jaugs.get_transform(img, r2, sem_seg=seg.copy())
        angles = [x.angle for x in t.tfms if isinstance(x, T.RotationTransform)]
        assert angles == [x.angle for x in jt.tfms if isinstance(x, JT.RotationTransform)]
        assert r1.rand() == r2.rand()
        _same(t.apply_image(img), jt.apply_image(img))
        _same(t.apply_segmentation(seg), jt.apply_segmentation(seg))
