"""The port's training transforms and augmentations
(``u2seg_torch/data/transforms.py``) against the JAX package's
(``u2seg_tpu/data/transforms.py``, which resizes with OpenCV), on seeded
numpy inputs.

Tolerances: uint8 resizes (OpenCV's fixed-point bilinear), nearest-neighbour
resizes, flips, crops, pads and uint8 blends are equal bit for bit; float
resizes agree to 1e-5 (f32 rounding of OpenCV's float path); boxes and
coordinates to 1e-9. Every augmentation is sampled from two RandomStates of
one seed, and both must leave their state at the same draw.
"""
import numpy as np
import pytest

from u2seg_tpu.config.config import Config as JConfig
from u2seg_tpu.data import transforms as JT
from u2seg_torch.config import Config
from u2seg_torch.data import transforms as T

SEEDS = range(20)
SIZES = [(480, 640), (427, 640), (640, 480), (500, 375), (37, 53), (1, 9)]


def _image(rng, h, w, kind):
    if kind == "u8":
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == "gray":
        return rng.randint(0, 256, (h, w)).astype(np.uint8)
    return (rng.rand(h, w, 3) * 255).astype(np.float32)


def _same_image(a, b, float_tol=1e-5):
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(a, b, rtol=0, atol=float_tol * max(1.0, np.abs(b).max()))
    else:
        np.testing.assert_array_equal(a, b)


def _same_geometry(t, jt, rng, h, w, seg=None):
    boxes = np.concatenate([rng.rand(7, 2) * [w / 2, h / 2],
                            rng.rand(7, 2) * [w / 2, h / 2] + [w / 2, h / 2]], 1)
    np.testing.assert_allclose(t.apply_box(boxes), jt.apply_box(boxes), rtol=0, atol=1e-9)
    coords = rng.rand(11, 2) * [w, h]
    np.testing.assert_allclose(t.apply_coords(coords.copy()), jt.apply_coords(coords.copy()),
                               rtol=0, atol=1e-9)
    if seg is not None:
        _same_image(t.apply_segmentation(seg), jt.apply_segmentation(seg))


# ---------------------------------------------------------------------------
# the resize kernels
# ---------------------------------------------------------------------------

RESIZES = [((480, 640), (800, 1067)), ((427, 640), (800, 1199)), ((640, 480), (1067, 800)),
           ((500, 375), (1333, 1000)), ((100, 200), (50, 100)), ((64, 64), (32, 32)),
           ((480, 640), (240, 320)), ((101, 203), (37, 19)), ((7, 9), (1, 1)),
           ((1, 1), (5, 7)), ((1, 9), (4, 3)), ((9, 1), (3, 4)), ((3, 5), (300, 500)),
           ((800, 1067), (400, 533)), ((33, 47), (66, 94))]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_uint8_and_nearest_resize_equal_cv2_bit_for_bit(src, dst):
    rng = np.random.RandomState(sum(src) + sum(dst))
    for kind in ("u8", "gray"):
        img = _image(rng, *src, kind)
        jt, t = JT.ResizeTransform(*src, *dst), T.ResizeTransform(*src, *dst)
        _same_image(t.apply_image(img), jt.apply_image(img))
        _same_image(t.apply_segmentation(img), jt.apply_segmentation(img))
    seg = rng.randint(0, 28, src).astype(np.uint8)
    _same_image(t.apply_segmentation(seg), jt.apply_segmentation(seg))


@pytest.mark.parametrize("src,dst", RESIZES[:8])
def test_float_resize_agrees_with_cv2(src, dst):
    rng = np.random.RandomState(7)
    img = _image(rng, *src, "f32")
    _same_image(T.ResizeTransform(*src, *dst).apply_image(img),
                JT.ResizeTransform(*src, *dst).apply_image(img))
    patch = (rng.rand(*src) > 0.5).astype(np.float32)          # a mask crop
    _same_image(T.resize_bilinear(patch, 64, 64),
                JT.ResizeTransform(*src, 64, 64).apply_image(patch))


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def _transforms(rng, h, w):
    """(name, port transform, JAX transform) triples with drawn parameters."""
    nh, nw = int(rng.randint(1, 2 * h + 1)), int(rng.randint(1, 2 * w + 1))
    x0, y0 = int(rng.randint(0, w)), int(rng.randint(0, h))
    cw, ch = int(rng.randint(1, w - x0 + 1)), int(rng.randint(1, h - y0 + 1))
    pads = [int(v) for v in rng.randint(0, 9, 4)]
    ws, wd = float(rng.rand()), float(rng.rand() * 1.5)
    src = rng.rand(h, w, 1) * 255
    out = [("noop", T.NoOpTransform(), JT.NoOpTransform()),
           ("resize", T.ResizeTransform(h, w, nh, nw), JT.ResizeTransform(h, w, nh, nw)),
           ("hflip", T.HFlipTransform(w), JT.HFlipTransform(w)),
           ("crop", T.CropTransform(x0, y0, cw, ch), JT.CropTransform(x0, y0, cw, ch)),
           ("pad", T.PadTransform(*pads), JT.PadTransform(*pads)),
           ("blend_scalar", T.BlendTransform(117.3, ws, wd), JT.BlendTransform(117.3, ws, wd)),
           ("blend_image", T.BlendTransform(src, ws, wd), JT.BlendTransform(src, ws, wd))]
    out.append(("list", T.TransformList([t for _, t, _ in out[1:5]]),
                JT.TransformList([j for _, _, j in out[1:5]])))
    return out


def test_every_transform_matches_jax_on_20_seeds():
    for seed in SEEDS:
        rng = np.random.RandomState(seed)
        h, w = SIZES[seed % len(SIZES)] if seed % 2 else (int(rng.randint(2, 90)),
                                                          int(rng.randint(2, 90)))
        seg = rng.randint(0, 256, (h, w)).astype(np.uint8)
        for name, t, jt in _transforms(rng, h, w):
            for kind in ("u8", "f32", "gray"):
                if name == "blend_image" and kind == "gray":
                    continue
                img = _image(rng, h, w, kind)
                _same_image(t.apply_image(img), jt.apply_image(img))
            _same_geometry(t, jt, rng, h, w, seg)


# ---------------------------------------------------------------------------
# augmentations
# ---------------------------------------------------------------------------

def _augs(rng, h, w):
    return {
        "shortest_edge_choice": lambda m: m.ResizeShortestEdge((240, 480, 800, 1024), 1333, "choice"),
        "shortest_edge_range": lambda m: m.ResizeShortestEdge((320, 900), 1000, "range"),
        "flip": lambda m: m.RandomFlip(0.5),
        "apply_flip": lambda m: m.RandomApply(m.RandomFlip(1.0), 0.5),
        "resize": lambda m: m.Resize((int(h * 0.7) + 1, int(w * 1.3) + 1)),
        "random_resize": lambda m: m.RandomResize([(64, 80), (100, 50), (h, w)]),
        "resize_scale": lambda m: m.ResizeScale(0.1, 2.0, 256, 256),
        "fixed_size_crop": lambda m: m.FixedSizeCrop((int(h * 0.8) + 1, int(w * 1.2) + 1)),
        "crop_relative": lambda m: m.RandomCrop("relative", (0.6, 0.7)),
        "crop_relative_range": lambda m: m.RandomCrop("relative_range", (0.3, 0.5)),
        "crop_absolute": lambda m: m.RandomCrop("absolute", (40, 60)),
        "crop_absolute_range": lambda m: m.RandomCrop("absolute_range", (10, 70)),
        "crop_category_area": lambda m: m.RandomCropWithCategoryAreaConstraint(
            "relative_range", (0.3, 0.3), 0.4, ignored_category=255),
        "contrast": lambda m: m.RandomContrast(0.5, 1.5),
        "brightness": lambda m: m.RandomBrightness(0.5, 1.5),
        "saturation": lambda m: m.RandomSaturation(0.5, 1.5),
        "lighting": lambda m: m.RandomLighting(0.5),
        "list": lambda m: m.AugmentationList([
            m.RandomCropWithCategoryAreaConstraint("relative_range", (0.5, 0.5), 0.6),
            m.ResizeShortestEdge((128, 200), 333), m.RandomBrightness(0.8, 1.2),
            m.RandomContrast(0.8, 1.2), m.RandomSaturation(0.8, 1.2), m.RandomFlip()]),
    }


AUGS = list(_augs(None, 1, 1))


@pytest.mark.parametrize("name", AUGS)
def test_augmentation_matches_jax_on_20_seeds(name):
    for seed in SEEDS:
        rng = np.random.RandomState(seed)
        h, w = SIZES[seed % 4] if seed % 3 == 0 else (int(rng.randint(20, 200)),
                                                      int(rng.randint(20, 200)))
        make = _augs(rng, h, w)[name]
        img = _image(rng, h, w, "u8")
        seg = np.where(rng.rand(h, w) < 0.1, 255,
                       (np.arange(h)[:, None] * 5 // h)).astype(np.uint8)
        extras = {"sem_seg": seg} if name in ("crop_category_area", "list") else {}
        r1, r2 = np.random.RandomState(1000 + seed), np.random.RandomState(1000 + seed)
        t = T._call_aug(make(T), img, r1, dict(extras)) if name != "list" else \
            make(T).get_transform(img, r1, **dict(extras))
        jt = JT._call_aug(make(JT), img, r2, dict(extras)) if name != "list" else \
            make(JT).get_transform(img, r2, **dict(extras))
        assert type(t).__name__ == type(jt).__name__
        assert r1.randint(2 ** 31) == r2.randint(2 ** 31), "the draws diverged"
        _same_image(t.apply_image(img), jt.apply_image(img))
        _same_image(t.apply_image(img.astype(np.float32)), jt.apply_image(img.astype(np.float32)))
        _same_geometry(t, jt, rng, h, w, seg)


RECIPES = {
    "default": {},
    "lsj": {"lsj": True, "lsj_image_size": 256},
    "crop": {"crop_enabled": True, "crop_type": "relative_range", "crop_size": (0.5, 0.5),
             "crop_single_category_max_area": 0.6},
    "color": {"color_aug": True, "random_flip": False},
}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_build_augmentation_matches_jax(recipe):
    cfg, jcfg = Config(), JConfig()
    for c in (cfg, jcfg):
        for k, v in RECIPES[recipe].items():
            setattr(c.input, k, v)
    for is_train in (True, False):
        augs = T.build_augmentation(cfg.input, is_train)
        jaugs = JT.build_augmentation(jcfg.input, is_train)
        assert [type(a).__name__ for a in augs.augs] == [type(a).__name__ for a in jaugs.augs]
        for seed in range(6):
            rng = np.random.RandomState(seed)
            h, w = SIZES[seed % 4]
            img = _image(rng, h, w, "u8")
            seg = rng.randint(0, 28, (h, w)).astype(np.uint8)
            r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
            t = augs.get_transform(img, r1, sem_seg=seg)
            jt = jaugs.get_transform(img, r2, sem_seg=seg)
            assert r1.rand() == r2.rand()
            _same_image(t.apply_image(img), jt.apply_image(img))
            _same_geometry(t, jt, rng, h, w, seg)


def test_rotation_raises_and_names_the_roadmap_item():
    # rotation is ported now: the recipe builds, with the JAX package's
    # augmentation at the JAX package's place, and warps as it does
    cfg, jcfg = Config(), JConfig()
    cfg.input.rotation_enabled = jcfg.input.rotation_enabled = True
    augs = T.build_augmentation(cfg.input, True)
    jaugs = JT.build_augmentation(jcfg.input, True)
    assert [type(a).__name__ for a in augs.augs] == [type(a).__name__ for a in jaugs.augs]
    assert "RandomRotation" in [type(a).__name__ for a in augs.augs]
    rng = np.random.RandomState(3)
    img = _image(rng, 37, 53, "u8")
    t = augs.get_transform(img, np.random.RandomState(5))
    jt = jaugs.get_transform(img, np.random.RandomState(5))
    _same_image(t.apply_image(img), jt.apply_image(img))


def test_pick_bucket_matches_jax():
    buckets = ((800, 1344), (1344, 800), (1056, 1056))
    rng = np.random.RandomState(0)
    for _ in range(200):
        h, w = int(rng.randint(1, 1500)), int(rng.randint(1, 1500))
        assert T.pick_bucket(h, w, buckets) == JT.pick_bucket(h, w, buckets)
