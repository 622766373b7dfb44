"""The port's image files (``u2seg_torch/data/image_io.py``) against the JAX
package's readers and writers: ``u2seg_tpu.data.mapper.read_image``, the
JAX driver's sem-seg GT read (``np.asarray(Image.open(path))``) and
``u2seg_tpu.pseudo.assembly``'s panoptic PNG codec. Every comparison is
exact.
"""
import builtins

import numpy as np
import pytest
from PIL import Image

from u2seg_tpu.data.mapper import read_image as jax_read_image
from u2seg_tpu.pseudo import assembly
from u2seg_torch.data import image_io


def scene(rng, h, w, c):
    """Smooth ramps with a noisy band and a flat patch."""
    yy, xx = np.mgrid[0:h, 0:w]
    ch = [(xx * (0.3 + k) + yy * (0.2 + 0.1 * k)) % 256 for k in range(c)]
    img = np.stack(ch, -1).astype(np.uint8)
    img[h // 3:h // 3 + 5] = rng.randint(0, 256, (min(5, h - h // 3), w, c))
    img[h // 2:, : w // 4] = 17
    return img[..., 0] if c == 1 else img


def save(path, mode, seed=0, h=45, w=66):
    """A file of one Pillow mode: gray, gray + alpha, RGB, RGBA, palette
    (the palette indices differ from any of the RGB channels)."""
    rng = np.random.RandomState(seed)
    if mode == "P":
        Image.fromarray(scene(rng, h, w, 3)).quantize(64).save(path)
    elif mode == "I;16":
        Image.fromarray(rng.randint(0, 1 << 16, (h, w)).astype(np.uint16)).save(path)
    else:
        c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        Image.fromarray(scene(rng, h, w, c), mode).save(path)
    return path


@pytest.mark.parametrize("fmt", ["RGB", "BGR", "L", "keep"])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_read_image_matches_the_jax_reader(tmp_path, mode, fmt):
    path = save(str(tmp_path / "x.png"), mode, seed=len(mode))
    got, ref = image_io.read_image(path, fmt), jax_read_image(path, fmt)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_the_jax_reader(tmp_path, orientation):
    exif = Image.Exif()
    exif[0x0112] = orientation
    for ext in ("png", "jpg"):
        path = str(tmp_path / f"e.{ext}")
        Image.fromarray(scene(np.random.RandomState(5), 21, 34, 3)).save(path, exif=exif)
        for fmt in ("RGB", "L"):
            np.testing.assert_array_equal(image_io.read_image(path, fmt),
                                          jax_read_image(path, fmt))


@pytest.mark.parametrize("mode", ["L", "P", "I;16"])
def test_sem_seg_gt_reads_as_the_jax_driver_reads_it(tmp_path, mode):
    path = save(str(tmp_path / "gt.png"), mode, seed=3)
    with Image.open(path) as im:
        ref = np.asarray(im)
    got = image_io.read_sem_seg(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_writer_round_trips_through_the_jax_reader(tmp_path, c):
    arr = scene(np.random.RandomState(c), 37, 29, c)
    path = str(tmp_path / "w.png")
    image_io.write_png(path, arr)
    np.testing.assert_array_equal(image_io.read_sem_seg(path), arr)
    np.testing.assert_array_equal(jax_read_image(path, "keep"), arr)


def test_without_pillow_every_call_names_the_file(tmp_path, monkeypatch):
    path = save(str(tmp_path / "photo.png"), "RGB")
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    for call in (lambda: image_io.read_image(path), lambda: image_io.read_sem_seg(path),
                 lambda: image_io.read_panoptic_png(path),
                 lambda: image_io.write_png(path, np.zeros((2, 2), np.uint8))):
        with pytest.raises(ImportError, match="photo.png"):
            call()


def test_rgb_id_codec_matches_jax():
    ids = np.random.RandomState(3).randint(0, 1 << 24, (19, 23))
    np.testing.assert_array_equal(image_io.id2rgb(ids), assembly.id2rgb(ids))
    rgb = image_io.id2rgb(ids)
    np.testing.assert_array_equal(image_io.rgb2id(rgb), assembly.rgb2id(rgb))
    np.testing.assert_array_equal(image_io.rgb2id(rgb), ids)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_panoptic_png_round_trip_matches_jax(tmp_path, writer):
    rng = np.random.RandomState(4)
    pan = rng.choice(rng.randint(1, 1 << 24, 12), (40, 56))
    pan[:5] = 0
    path = str(tmp_path / "pan.png")
    (image_io.write_panoptic_png if writer == "port"
     else assembly.write_panoptic_png)(pan, path)
    got = image_io.read_panoptic_png(path)
    ref = assembly.read_panoptic_png(path)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pan)
