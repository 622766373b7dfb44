"""Host-side image transforms and augmentations (counterpart of
``u2seg_tpu/data/transforms.py``; detectron2's ``data/transforms``).

Each transform is a small object with ``apply_image`` / ``apply_box`` /
``apply_coords`` / ``apply_segmentation`` so that box and mask geometry
stays consistent with the pixels; an augmentation samples a transform from
an image and a ``numpy.random.RandomState``, drawing from it in the JAX
package's order.

The JAX package resizes with OpenCV. The port needs no OpenCV and computes
what OpenCV computes, by the image's type:
- ``uint8`` images (the training mapper): OpenCV's fixed-point bilinear
  (``resize_bilinear_u8``, torch CPU ops), equal to ``cv2.resize`` bit for
  bit;
- float images (the predictor, mask patches): ``resize_bilinear``,
  half-pixel centres, border replicate, in f32; equal to ``cv2.resize`` to
  f32 rounding;
- segmentation maps and masks: OpenCV's nearest neighbour
  (``resize_nearest``), bit for bit.

Rotation and extent warp through ``data/warp.py`` (``cv2.warpAffine``,
``cv2.getRotationMatrix2D`` and ``cv2.transform`` without OpenCV, bit for
bit on uint8): images linear, segmentation maps nearest.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from u2seg_torch.data import warp

# OpenCV's fixed-point bilinear: 11-bit coefficients (INTER_RESIZE_COEF_BITS)
_COEF_SCALE = 2048


def _axis_taps(dst: int, src: int):
    """Source cells and weights of a ``src`` -> ``dst`` linear resize along
    one axis: ``coord = (i + 0.5) * src / dst - 0.5`` clamped into
    ``[0, src - 1]`` -> (lower cell (dst,), upper cell, upper weight f32)."""
    coord = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    coord = np.clip(coord, 0.0, src - 1.0)
    lo = np.floor(coord).astype(np.int64)
    hi = np.minimum(lo + 1, src - 1)
    return lo, hi, (coord - lo).astype(np.float32)


def resize_bilinear(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Float bilinear resize of ``(H, W)`` or ``(H, W, C)`` to ``(new_h,
    new_w[, C])`` in f32: columns first, then rows."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    tail = (1,) * (img.ndim - 2)
    lo, hi, t = _axis_taps(new_w, w)
    t = t.reshape((1, -1) + tail)
    img = img[:, lo] * (1.0 - t) + img[:, hi] * t
    lo, hi, t = _axis_taps(new_h, h)
    t = t.reshape((-1, 1) + tail)
    return img[lo] * (1.0 - t) + img[hi] * t


def _u8_taps(dst: int, src: int, zero_at_border: bool):
    """OpenCV's taps of a ``src`` -> ``dst`` uint8 linear resize along one
    axis: ``f = float32((i + 0.5) * src / dst - 0.5)``, cell ``floor(f)``,
    11-bit weights ``rint((1 - frac) * 2048)``, ``rint(frac * 2048)``.
    Columns (``zero_at_border``) outside ``[0, src - 1)`` take the border
    cell at full weight; rows only clamp their cell indices."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    cell = np.floor(f).astype(np.int64)
    frac = (f - cell.astype(np.float32)).astype(np.float32)
    if zero_at_border:
        low, high = cell < 0, cell >= src - 1
        frac[low | high] = 0
        cell[low] = 0
        cell[high] = src - 1
    w1 = np.rint(frac * np.float32(_COEF_SCALE)).astype(np.int32)
    w0 = np.rint((np.float32(1) - frac) * np.float32(_COEF_SCALE)).astype(np.int32)
    lo, hi = np.clip(cell, 0, src - 1), np.clip(cell + 1, 0, src - 1)
    return (torch.from_numpy(lo), torch.from_numpy(hi),
            torch.from_numpy(w0), torch.from_numpy(w1))


def resize_bilinear_u8(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """``cv2.resize(img, (new_w, new_h), interpolation=INTER_LINEAR)`` of a
    uint8 ``(H, W)`` or ``(H, W, C)`` image, bit for bit: rows of 11-bit
    horizontal sums ``H`` (int32), then ``((b0 * (H0 >> 4)) >> 16) +
    ((b1 * (H1 >> 4)) >> 16) + 2) >> 2``, saturated. Torch CPU ops, which
    leave the GIL to the loader's other threads."""
    src = torch.from_numpy(np.ascontiguousarray(img)).to(torch.int32)
    h, w = src.shape[:2]
    tail = (1,) * (src.dim() - 2)
    x0, x1, a0, a1 = _u8_taps(new_w, w, zero_at_border=True)
    y0, y1, b0, b1 = _u8_taps(new_h, h, zero_at_border=False)
    rows = torch.unique(torch.cat([y0, y1]))            # sorted source rows
    src = src.index_select(0, rows)
    hsum = (src.index_select(1, x0) * a0.view((1, -1) + tail)
            + src.index_select(1, x1) * a1.view((1, -1) + tail))
    pos = torch.searchsorted(rows, torch.stack([y0, y1]))
    top = (b0.view((-1, 1) + tail) * (hsum.index_select(0, pos[0]) >> 4)) >> 16
    bot = (b1.view((-1, 1) + tail) * (hsum.index_select(0, pos[1]) >> 4)) >> 16
    return ((top + bot + 2) >> 2).clamp_(0, 255).to(torch.uint8).numpy()


def resize_nearest(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """``cv2.resize(..., interpolation=INTER_NEAREST)``: source cell
    ``floor(i * (1 / (dst / src)))`` (no half-pixel centres), clamped."""
    h, w = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(new_h) * (1.0 / (new_h / h))).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(new_w) * (1.0 / (new_w / w))).astype(np.int64), w - 1)
    return np.ascontiguousarray(img[ys][:, xs])


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------

class Transform:
    def apply_image(self, img: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def apply_box(self, boxes: np.ndarray) -> np.ndarray:
        """XYXY boxes: the bounding box of the four transformed corners (as
        in detectron2). The JAX package maps two corners only, which is
        the same for axis-aligned transforms and wrong for a rotation."""
        if len(boxes) == 0:
            return boxes
        idx = np.array([0, 1, 2, 1, 0, 3, 2, 3])
        corners = np.asarray(boxes).reshape(-1, 4)[:, idx].reshape(-1, 2)
        c = self.apply_coords(corners.astype(np.float64)).reshape(-1, 4, 2)
        return np.concatenate([c.min(axis=1), c.max(axis=1)], axis=1)

    def apply_segmentation(self, seg: np.ndarray) -> np.ndarray:
        return self.apply_image(seg)


class NoOpTransform(Transform):
    def apply_image(self, img):
        return img

    def apply_coords(self, coords):
        return coords


class ResizeTransform(Transform):
    """Resize ``(h, w) -> (new_h, new_w)``: bilinear images (uint8 or
    float), nearest-neighbour segmentation maps."""

    def __init__(self, h: int, w: int, new_h: int, new_w: int):
        self.h, self.w, self.new_h, self.new_w = h, w, new_h, new_w

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        if (self.h, self.w) == (self.new_h, self.new_w):
            return img
        if img.dtype == np.uint8:
            return resize_bilinear_u8(img, self.new_h, self.new_w)
        if not np.issubdtype(img.dtype, np.floating):
            raise TypeError("ResizeTransform.apply_image takes uint8 or float images "
                            f"(got {img.dtype})")
        return resize_bilinear(img, self.new_h, self.new_w)

    def apply_coords(self, coords):
        coords = coords.astype(np.float64).copy()
        coords[:, 0] *= self.new_w / self.w
        coords[:, 1] *= self.new_h / self.h
        return coords

    def apply_segmentation(self, seg):
        if (self.h, self.w) == (self.new_h, self.new_w):
            return seg
        return resize_nearest(seg, self.new_h, self.new_w)


class HFlipTransform(Transform):
    def __init__(self, width: int):
        self.width = width

    def apply_image(self, img):
        return np.ascontiguousarray(img[:, ::-1])

    def apply_coords(self, coords):
        coords = coords.astype(np.float64).copy()
        coords[:, 0] = self.width - coords[:, 0]
        return coords


class CropTransform(Transform):
    """Crop ``[y0:y0+h, x0:x0+w]``; coords shift by (-x0, -y0)."""

    def __init__(self, x0: int, y0: int, w: int, h: int):
        self.x0, self.y0, self.w, self.h = int(x0), int(y0), int(w), int(h)

    def apply_image(self, img):
        return np.ascontiguousarray(
            img[self.y0:self.y0 + self.h, self.x0:self.x0 + self.w])

    def apply_coords(self, coords):
        coords = coords.astype(np.float64).copy()
        coords[:, 0] -= self.x0
        coords[:, 1] -= self.y0
        return coords


class PadTransform(Transform):
    """Pad left/top by (x0, y0) and right/bottom by (x1, y1) with a constant;
    segmentation pads with ``seg_pad_value``."""

    def __init__(self, x0: int, y0: int, x1: int, y1: int,
                 pad_value: float = 128.0, seg_pad_value: int = 255):
        self.x0, self.y0, self.x1, self.y1 = int(x0), int(y0), int(x1), int(y1)
        self.pad_value = pad_value
        self.seg_pad_value = seg_pad_value

    def _pad(self, img, value):
        pads = [(self.y0, self.y1), (self.x0, self.x1)]
        pads += [(0, 0)] * (img.ndim - 2)
        return np.pad(img, pads, constant_values=value)

    def apply_image(self, img):
        return self._pad(img, self.pad_value)

    def apply_coords(self, coords):
        coords = coords.astype(np.float64).copy()
        coords[:, 0] += self.x0
        coords[:, 1] += self.y0
        return coords

    def apply_segmentation(self, seg):
        return self._pad(seg, self.seg_pad_value)


class BlendTransform(Transform):
    """``src_weight * src_image + dst_weight * img``, the photometric
    primitive; uint8 images are blended in float and truncated back (the
    JAX package's numpy expression, promotions included). Geometry is
    untouched."""

    def __init__(self, src_image, src_weight: float, dst_weight: float):
        self.src_image = src_image
        self.src_weight = src_weight
        self.dst_weight = dst_weight

    def apply_image(self, img):
        if img.dtype == np.uint8:
            out = (self.src_weight * self.src_image
                   + self.dst_weight * img.astype(np.float32))
            return np.clip(out, 0, 255).astype(np.uint8)
        return self.src_weight * self.src_image + self.dst_weight * img

    def apply_coords(self, coords):
        return coords

    def apply_segmentation(self, seg):
        return seg


class RotationTransform(Transform):
    """Rotate ``angle`` degrees counter-clockwise around ``center`` (the
    image centre by default), with detectron2's half-pixel image offset and,
    with ``expand``, an output that holds the whole rotated image."""

    def __init__(self, h: int, w: int, angle: float, expand: bool = True,
                 center: Optional[Tuple[float, float]] = None,
                 interp: Optional[str] = None):
        self.h, self.w, self.angle, self.expand = h, w, angle, expand
        image_center = np.array((w / 2, h / 2))
        self.center = image_center if center is None else np.asarray(center)
        self.image_center = image_center
        self.interp = "linear" if interp is None else interp
        abs_cos = abs(np.cos(np.deg2rad(angle)))
        abs_sin = abs(np.sin(np.deg2rad(angle)))
        if expand:
            self.bound_w, self.bound_h = np.rint(
                [h * abs_sin + w * abs_cos, h * abs_cos + w * abs_sin]).astype(int)
        else:
            self.bound_w, self.bound_h = w, h
        self.rm_coords = self._rotation_matrix()
        # the warp samples pixel centres at integer coordinates: shifting by
        # -0.5 makes the image map agree with the geometric one
        self.rm_image = self._rotation_matrix(offset=-0.5)

    def _rotation_matrix(self, offset: float = 0.0) -> np.ndarray:
        center = (self.center[0] + offset, self.center[1] + offset)
        rm = warp.get_rotation_matrix_2d(center, self.angle, 1)
        if self.expand:
            rot_center = warp.transform(self.image_center[None, None, :] + offset, rm)[0, 0, :]
            rm[:, 2] += (np.array([self.bound_w / 2, self.bound_h / 2]) + offset
                         - rot_center)
        return rm

    def apply_image(self, img, interp: Optional[str] = None):
        if len(img) == 0 or self.angle % 360 == 0:
            return img
        return warp.warp_affine(img, self.rm_image, (self.bound_w, self.bound_h),
                                self.interp if interp is None else interp)

    def apply_coords(self, coords):
        coords = np.asarray(coords, dtype=np.float64)
        if len(coords) == 0 or self.angle % 360 == 0:
            return coords
        return warp.transform(coords[:, np.newaxis, :], self.rm_coords)[:, 0, :]

    def apply_segmentation(self, seg):
        return self.apply_image(seg, interp="nearest")


class ExtentTransform(Transform):
    """Resample the source rectangle ``src_rect`` (x0, y0, x1, y1; it may
    reach past the image, where pixels read zero) onto an ``output_size``
    (h, w) grid: PIL's EXTENT as an affine warp,
    ``dst = (src - rect0) * scale - 0.5`` in pixel-centre terms."""

    def __init__(self, src_rect: Tuple[float, float, float, float],
                 output_size: Tuple[int, int], interp: Optional[str] = None):
        self.src_rect = src_rect
        self.output_size = output_size
        self.interp = interp

    def _matrix(self) -> np.ndarray:
        x0, y0, x1, y1 = self.src_rect
        out_h, out_w = self.output_size
        sx = out_w / (x1 - x0)
        sy = out_h / (y1 - y0)
        return np.array([[sx, 0, -x0 * sx - 0.5 + 0.5 * sx],
                         [0, sy, -y0 * sy - 0.5 + 0.5 * sy]], np.float64)

    def apply_image(self, img):
        out_h, out_w = self.output_size
        interp = self.interp if self.interp is not None else "linear"
        return warp.warp_affine(img, self._matrix(), (out_w, out_h), interp, 0)

    def apply_coords(self, coords):
        x0, y0, x1, y1 = self.src_rect
        out_h, out_w = self.output_size
        coords = coords.astype(np.float64).copy()
        coords[:, 0] = (coords[:, 0] - x0) * (out_w / (x1 - x0))
        coords[:, 1] = (coords[:, 1] - y0) * (out_h / (y1 - y0))
        return coords

    def apply_segmentation(self, seg):
        out_h, out_w = self.output_size
        return warp.warp_affine(seg, self._matrix(), (out_w, out_h), "nearest", 0)


class TransformList(Transform):
    def __init__(self, tfms: Sequence[Transform]):
        self.tfms = list(tfms)

    def apply_image(self, img):
        for t in self.tfms:
            img = t.apply_image(img)
        return img

    def apply_coords(self, coords):
        for t in self.tfms:
            coords = t.apply_coords(coords)
        return coords

    def apply_box(self, boxes):
        for t in self.tfms:
            boxes = t.apply_box(boxes)
        return boxes

    def apply_segmentation(self, seg):
        for t in self.tfms:
            seg = t.apply_segmentation(seg)
        return seg


# ---------------------------------------------------------------------------
# Augmentations (sample a Transform from image + rng)
# ---------------------------------------------------------------------------

class Augmentation:
    def get_transform(self, image: np.ndarray, rng: np.random.RandomState) -> Transform:
        raise NotImplementedError


class ResizeShortestEdge(Augmentation):
    """Resize the shortest edge to a sampled target (``choice`` of the
    lengths, or uniform in their ``range``), the longest edge capped at
    ``max_size``."""

    def __init__(self, short_edge_length, max_size: int = 1333,
                 sample_style: str = "choice"):
        if isinstance(short_edge_length, int):
            short_edge_length = (short_edge_length,)
        self.short_edge_length = tuple(short_edge_length)
        self.max_size = max_size
        self.sample_style = sample_style

    @staticmethod
    def get_output_shape(h: int, w: int, size: int, max_size: int) -> Tuple[int, int]:
        scale = size / min(h, w)
        if h < w:
            new_h, new_w = size, scale * w
        else:
            new_h, new_w = scale * h, size
        if max(new_h, new_w) > max_size:
            s = max_size / max(new_h, new_w)
            new_h *= s
            new_w *= s
        return int(new_h + 0.5), int(new_w + 0.5)

    def get_transform(self, image, rng):
        h, w = image.shape[:2]
        if self.sample_style == "choice":
            size = int(rng.choice(self.short_edge_length))
        else:  # range
            size = int(rng.randint(
                self.short_edge_length[0], self.short_edge_length[-1] + 1))
        if size == 0:
            return NoOpTransform()
        new_h, new_w = self.get_output_shape(h, w, size, self.max_size)
        return ResizeTransform(h, w, new_h, new_w)


class RandomFlip(Augmentation):
    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def get_transform(self, image, rng):
        if rng.rand() < self.prob:
            return HFlipTransform(image.shape[1])
        return NoOpTransform()


class RandomApply(Augmentation):
    """Apply ``aug`` with probability ``prob``."""

    def __init__(self, aug: Augmentation, prob: float = 0.5):
        self.aug = aug
        self.prob = prob

    def get_transform(self, image, rng, **extras):
        if rng.rand() < self.prob:
            return _call_aug(self.aug, image, rng, extras)
        return NoOpTransform()


class Resize(Augmentation):
    """Resize to a fixed (h, w)."""

    def __init__(self, shape: Tuple[int, int]):
        self.shape = shape

    def get_transform(self, image, rng):
        h, w = image.shape[:2]
        return ResizeTransform(h, w, self.shape[0], self.shape[1])


class RandomResize(Augmentation):
    """Resize to a random (h, w) of ``shape_list``."""

    def __init__(self, shape_list: Sequence[Tuple[int, int]]):
        self.shape_list = list(shape_list)

    def get_transform(self, image, rng):
        h, w = image.shape[:2]
        nh, nw = self.shape_list[rng.randint(len(self.shape_list))]
        return ResizeTransform(h, w, nh, nw)


class ResizeScale(Augmentation):
    """Scale the (target_h, target_w) box by uniform(min_scale, max_scale)
    and fit the image inside it, keeping its aspect ratio (the resize half
    of large-scale jitter)."""

    def __init__(self, min_scale: float, max_scale: float,
                 target_height: int, target_width: int):
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.target_height = target_height
        self.target_width = target_width

    def get_transform(self, image, rng):
        h, w = image.shape[:2]
        scale = rng.uniform(self.min_scale, self.max_scale)
        out_scale = min(self.target_height * scale / h,
                        self.target_width * scale / w)
        new_h = int(np.round(h * out_scale))
        new_w = int(np.round(w * out_scale))
        return ResizeTransform(h, w, new_h, new_w)


class FixedSizeCrop(Augmentation):
    """Random crop to ``crop_size`` where larger, right/bottom pad where
    smaller (the crop half of large-scale jitter)."""

    def __init__(self, crop_size: Tuple[int, int], pad: bool = True,
                 pad_value: float = 128.0, seg_pad_value: int = 255):
        self.crop_size = tuple(crop_size)
        self.pad = pad
        self.pad_value = pad_value
        self.seg_pad_value = seg_pad_value

    def get_transform(self, image, rng):
        h, w = image.shape[:2]
        ch, cw = self.crop_size
        oy = int(round(max(h - ch, 0) * rng.uniform(0.0, 1.0)))
        ox = int(round(max(w - cw, 0) * rng.uniform(0.0, 1.0)))
        tfms = [CropTransform(ox, oy, min(cw, w), min(ch, h))]
        if self.pad:
            tfms.append(PadTransform(
                0, 0, max(cw - w, 0), max(ch - h, 0),
                self.pad_value, self.seg_pad_value))
        return TransformList(tfms)


class RandomCrop(Augmentation):
    """Random crop of a fixed or relative size."""

    def __init__(self, crop_type: str, crop_size):
        if crop_type not in ("relative", "relative_range", "absolute", "absolute_range"):
            raise ValueError(f"unknown crop_type {crop_type!r}")
        self.crop_type = crop_type
        self.crop_size = crop_size

    def get_crop_size(self, image_size, rng) -> Tuple[int, int]:
        h, w = image_size
        if self.crop_type == "relative":
            ch, cw = self.crop_size
            return int(h * ch + 0.5), int(w * cw + 0.5)
        if self.crop_type == "relative_range":
            lo = np.asarray(self.crop_size, np.float32)
            ch, cw = lo + rng.rand(2) * (1 - lo)
            return int(h * ch + 0.5), int(w * cw + 0.5)
        if self.crop_type == "absolute":
            return min(self.crop_size[0], h), min(self.crop_size[1], w)
        if self.crop_size[0] > self.crop_size[1]:
            raise ValueError(f"absolute_range needs lo <= hi, got {self.crop_size}")
        ch = rng.randint(min(h, self.crop_size[0]), min(h, self.crop_size[1]) + 1)
        cw = rng.randint(min(w, self.crop_size[0]), min(w, self.crop_size[1]) + 1)
        return ch, cw

    def get_transform(self, image, rng):
        h, w = image.shape[:2]
        ch, cw = self.get_crop_size((h, w), rng)
        y0 = rng.randint(h - ch + 1)
        x0 = rng.randint(w - cw + 1)
        return CropTransform(x0, y0, cw, ch)


class RandomCropWithCategoryAreaConstraint(Augmentation):
    """RandomCrop that retries (up to 10 times) until no semantic category
    covers more than ``single_category_max_area`` of the crop."""

    needs = ("sem_seg",)

    def __init__(self, crop_type: str, crop_size,
                 single_category_max_area: float = 1.0,
                 ignored_category: Optional[int] = None):
        self.crop_aug = RandomCrop(crop_type, crop_size)
        self.single_category_max_area = single_category_max_area
        self.ignored_category = ignored_category

    def get_transform(self, image, rng, sem_seg=None):
        if self.single_category_max_area >= 1.0 or sem_seg is None:
            return self.crop_aug.get_transform(image, rng)
        h, w = sem_seg.shape
        for _ in range(10):
            ch, cw = self.crop_aug.get_crop_size((h, w), rng)
            y0 = rng.randint(h - ch + 1)
            x0 = rng.randint(w - cw + 1)
            window = sem_seg[y0:y0 + ch, x0:x0 + cw]
            labels, cnt = np.unique(window, return_counts=True)
            if self.ignored_category is not None:
                cnt = cnt[labels != self.ignored_category]
            if len(cnt) > 1 and np.max(cnt) < np.sum(cnt) * self.single_category_max_area:
                break
        return CropTransform(x0, y0, cw, ch)


class RandomContrast(Augmentation):
    """Blend with the image mean."""

    def __init__(self, intensity_min: float, intensity_max: float):
        self.intensity_min, self.intensity_max = intensity_min, intensity_max

    def get_transform(self, image, rng):
        w = rng.uniform(self.intensity_min, self.intensity_max)
        return BlendTransform(image.mean(), src_weight=1 - w, dst_weight=w)


class RandomBrightness(Augmentation):
    """Blend with black."""

    def __init__(self, intensity_min: float, intensity_max: float):
        self.intensity_min, self.intensity_max = intensity_min, intensity_max

    def get_transform(self, image, rng):
        w = rng.uniform(self.intensity_min, self.intensity_max)
        return BlendTransform(0, src_weight=1 - w, dst_weight=w)


class RandomSaturation(Augmentation):
    """Blend with the luma grayscale of an RGB image."""

    def __init__(self, intensity_min: float, intensity_max: float):
        self.intensity_min, self.intensity_max = intensity_min, intensity_max

    def get_transform(self, image, rng):
        if image.shape[-1] != 3:
            raise ValueError("RandomSaturation needs an RGB image")
        w = rng.uniform(self.intensity_min, self.intensity_max)
        gray = image.dot([0.299, 0.587, 0.114])[:, :, np.newaxis]
        return BlendTransform(gray, src_weight=1 - w, dst_weight=w)


class RandomLighting(Augmentation):
    """AlexNet PCA lighting jitter over ImageNet statistics, RGB input."""

    _EIGEN_VECS = np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
    _EIGEN_VALS = np.array([0.2175, 0.0188, 0.0045])

    def __init__(self, scale: float):
        self.scale = scale

    def get_transform(self, image, rng):
        if image.shape[-1] != 3:
            raise ValueError("RandomLighting needs an RGB image")
        weights = rng.normal(scale=self.scale, size=3)
        return BlendTransform(
            self._EIGEN_VECS.dot(weights * self._EIGEN_VALS),
            src_weight=1.0, dst_weight=1.0)


class RandomRotation(Augmentation):
    """Rotate by a sampled angle (uniform in a ``range``, or a ``choice``),
    optionally around a sampled centre relative to the image size."""

    def __init__(self, angle, expand: bool = True, center=None,
                 sample_style: str = "range", interp: Optional[str] = None):
        assert sample_style in ("range", "choice"), sample_style
        self.is_range = sample_style == "range"
        if isinstance(angle, (float, int)):
            angle = (angle, angle)
        if center is not None and isinstance(center[0], (float, int)):
            center = (center, center)
        self.angle, self.expand, self.center = angle, expand, center
        self.interp = interp

    def get_transform(self, image, rng):
        h, w = image.shape[:2]
        center = None
        if self.is_range:
            angle = rng.uniform(self.angle[0], self.angle[1])
            if self.center is not None:
                center = (rng.uniform(self.center[0][0], self.center[1][0]),
                          rng.uniform(self.center[0][1], self.center[1][1]))
        else:
            angle = self.angle[rng.randint(len(self.angle))]
            if self.center is not None:
                center = self.center[rng.randint(len(self.center))]
        if center is not None:
            center = (w * center[0], h * center[1])
        if angle % 360 == 0:
            return NoOpTransform()
        return RotationTransform(h, w, angle, expand=self.expand,
                                 center=center, interp=self.interp)


class RandomExtent(Augmentation):
    """Take a randomly scaled and shifted rectangle around the image centre
    (it may reach past the image, which reads zero) at its own size."""

    def __init__(self, scale_range: Tuple[float, float],
                 shift_range: Tuple[float, float]):
        self.scale_range = scale_range
        self.shift_range = shift_range

    def get_transform(self, image, rng):
        h, w = image.shape[:2]
        rect = np.array([-0.5 * w, -0.5 * h, 0.5 * w, 0.5 * h])
        rect *= rng.uniform(self.scale_range[0], self.scale_range[1])
        rect[0::2] += self.shift_range[0] * w * (rng.rand() - 0.5)
        rect[1::2] += self.shift_range[1] * h * (rng.rand() - 0.5)
        rect[0::2] += 0.5 * w
        rect[1::2] += 0.5 * h
        return ExtentTransform(
            src_rect=tuple(rect),
            output_size=(int(rect[3] - rect[1]), int(rect[2] - rect[0])))


def _call_aug(aug: Augmentation, image, rng, extras: dict) -> Transform:
    """Invoke get_transform, forwarding only the extra inputs (sem_seg, ...)
    the augmentation declares in its ``needs`` attribute."""
    needs = getattr(aug, "needs", ())
    kwargs = {k: extras.get(k) for k in needs}
    return aug.get_transform(image, rng, **kwargs)


class AugmentationList(Augmentation):
    """Sample each augmentation on the image (and sem-seg map) that the
    previous ones produced."""

    def __init__(self, augs: Sequence[Augmentation]):
        self.augs = list(augs)

    def get_transform(self, image, rng, **extras):
        tfms = []
        for a in self.augs:
            t = _call_aug(a, image, rng, extras)
            tfms.append(t)
            image = t.apply_image(image)
            if extras.get("sem_seg") is not None:
                extras["sem_seg"] = t.apply_segmentation(extras["sem_seg"])
        return TransformList(tfms)


def build_augmentation(cfg_input, is_train: bool) -> AugmentationList:
    """The test resize, or the training recipe: the default multi-scale
    resize (optionally after a category-area-constrained crop) or
    large-scale jitter, then the rotation, the color augmentations and the
    flip."""
    if not is_train:
        return AugmentationList([ResizeShortestEdge(
            (cfg_input.min_size_test,), cfg_input.max_size_test, "choice")])

    augs: List[Augmentation] = []
    if cfg_input.lsj:
        size = cfg_input.lsj_image_size
        augs.append(ResizeScale(
            cfg_input.lsj_min_scale, cfg_input.lsj_max_scale, size, size))
        augs.append(FixedSizeCrop((size, size), pad=True))
    else:
        if cfg_input.crop_enabled:
            augs.append(RandomCropWithCategoryAreaConstraint(
                cfg_input.crop_type, cfg_input.crop_size,
                cfg_input.crop_single_category_max_area, ignored_category=255))
        augs.append(ResizeShortestEdge(
            cfg_input.min_size_train, cfg_input.max_size_train, "choice"))
    if cfg_input.rotation_enabled:
        augs.append(RandomRotation(
            list(cfg_input.rotation_angles), expand=cfg_input.rotation_expand,
            sample_style=cfg_input.rotation_sample_style))
    if cfg_input.color_aug:
        augs += [RandomBrightness(0.9, 1.1), RandomContrast(0.9, 1.1),
                 RandomSaturation(0.9, 1.1)]
    if cfg_input.random_flip:
        augs.append(RandomFlip(0.5))
    return AugmentationList(augs)


def pick_bucket(h: int, w: int, buckets: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """Smallest bucket that fits (h, w); the largest-area one if none does."""
    best = None
    best_area = None
    for bh, bw in buckets:
        if bh >= h and bw >= w:
            area = bh * bw
            if best_area is None or area < best_area:
                best, best_area = (bh, bw), area
    if best is None:
        best = max(buckets, key=lambda b: b[0] * b[1])
    return best
