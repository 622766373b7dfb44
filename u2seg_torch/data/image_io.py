"""Image files for the dataset path, read and written through Pillow as the
JAX package reads them: ``read_image`` (``u2seg_tpu/data/mapper.py:29-43``,
EXIF rotation applied), the sem-seg GT (``np.asarray(Image.open(path))``,
``u2seg_tpu/engine/predictor.py:559-563``) and the panoptic GT
(``u2seg_tpu/pseudo/assembly.py:196-205``, RGB -> id).

Pillow is imported inside each call, never when the module is imported;
without it a call raises an ImportError that names the file.
"""
from __future__ import annotations

import numpy as np


def _pil(path: str):
    try:
        from PIL import Image, ImageOps
    except ImportError as e:
        raise ImportError(f"{path}: image files are read and written with "
                          "Pillow, which is not installed") from e
    return Image, ImageOps


def read_image(path: str, format: str = "RGB") -> np.ndarray:
    """An image file as HWC uint8 with its EXIF rotation applied, in
    ``format`` ("RGB", "BGR", "L"; any other value keeps the file's own
    samples) (ref detection_utils.py:166)."""
    Image, ImageOps = _pil(path)
    with Image.open(path) as img:
        img = ImageOps.exif_transpose(img)
        if format == "RGB":
            img = img.convert("RGB")
        elif format == "BGR":
            img = img.convert("RGB")
            return np.asarray(img)[:, :, ::-1].copy()
        elif format == "L":
            img = img.convert("L")
        return np.asarray(img).copy()


def read_sem_seg(path: str) -> np.ndarray:
    """A sem-seg GT file's samples as stored (palette files: the indices),
    without EXIF rotation, as the JAX driver reads them."""
    Image, _ = _pil(path)
    with Image.open(path) as img:
        return np.asarray(img).copy()


def write_png(path: str, image: np.ndarray) -> None:
    """A uint8 (H, W) or (H, W, 2-4) array -> PNG file."""
    Image, _ = _pil(path)
    Image.fromarray(np.ascontiguousarray(image)).save(path, format="PNG")


def write_jpeg(path: str, image: np.ndarray) -> None:
    """A uint8 (H, W, 3) RGB array -> JPEG file (Pillow's default quality)."""
    Image, _ = _pil(path)
    Image.fromarray(np.ascontiguousarray(image)).save(path, format="JPEG")


def id2rgb(id_map: np.ndarray) -> np.ndarray:
    """Segment id -> RGB encoding (panopticapi convention, little-endian)."""
    out = np.zeros(id_map.shape + (3,), np.uint8)
    out[..., 0] = id_map % 256
    out[..., 1] = (id_map // 256) % 256
    out[..., 2] = id_map // (256 * 256)
    return out


def rgb2id(rgb: np.ndarray) -> np.ndarray:
    rgb = rgb.astype(np.int64)
    return rgb[..., 0] + rgb[..., 1] * 256 + rgb[..., 2] * 256 * 256


def write_panoptic_png(pan: np.ndarray, path: str) -> None:
    write_png(path, id2rgb(pan))


def read_panoptic_png(path: str) -> np.ndarray:
    """Panoptic PNG -> (H, W) int64 segment ids (no EXIF rotation, as the
    JAX package reads it)."""
    Image, _ = _pil(path)
    with Image.open(path) as img:
        return rgb2id(np.asarray(img.convert("RGB")))
