"""u2seg_torch's ``TTAPredictor`` vs the JAX package's around the same stub
predictor: resize to each test size (and mirror), map the boxes back, merge
by a class-aware greedy NMS. The stub answers with boxes, scores and classes
computed from the pixels it is given, so the outputs are equal exactly only
if the port's ``resize_bilinear_u8`` gives ``cv2.resize``'s pixels, bit for
bit. Tolerance: exact equality.
"""
import numpy as np
import pytest
import torch

from u2seg_tpu.models import tta as jtta
from u2seg_torch.models import tta as ttta
from u2seg_torch.testing import scene


class PixelStub:
    """A predictor whose 12 detections are functions of the image's pixels:
    boxes around the brightest cells of a 4 x 4 grid, scores from the cell
    means, classes from the dominant channel."""

    def __call__(self, img):
        h, w = img.shape[:2]
        f = img.astype(np.float64)
        gh, gw = h // 4, w // 4
        cells = f[:4 * gh, :4 * gw].reshape(4, gh, 4, gw, 3).mean(axis=(1, 3))
        energy = cells.sum(-1).reshape(-1)
        order = np.argsort(-energy, kind="stable")[:12]
        iy, ix = np.divmod(order, 4)
        jitter = (f[:, :, 0].sum() % 97) / 97.0 * gw / 4
        boxes = np.stack([ix * gw + jitter, iy * gh, (ix + 1.6) * gw, (iy + 1.6) * gh], -1)
        scores = energy[order] / (3 * 255.0)
        classes = cells.reshape(-1, 3)[order].argmax(-1)
        return {"instances": {"boxes": boxes, "scores": scores, "classes": classes}}


@pytest.mark.parametrize("hw,flip", [((120, 90), True), ((97, 131), False)])
def test_tta_matches_jax_exactly(hw, flip):
    img = scene(np.random.RandomState(hw[0]), *hw).astype(np.uint8)
    kw = dict(min_sizes=(64, 100, 150), max_size=200, flip=flip, nms_thresh=0.5,
              max_detections=20)
    ref = jtta.TTAPredictor(PixelStub(), **kw)(img)["instances"]
    got = ttta.TTAPredictor(PixelStub(), **kw)(img)["instances"]
    assert len(got["boxes"]) > 5
    for k in ("boxes", "scores", "classes"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_batched_nms_numpy_matches_jax():
    rng = np.random.RandomState(0)
    xy = rng.rand(300, 2) * 100
    boxes = np.concatenate([xy, xy + rng.rand(300, 2) * 40 + 1], 1)
    scores = np.round(rng.rand(300), 2)                 # ties
    classes = rng.randint(0, 3, 300)
    for t in (0.3, 0.5, 0.7):
        np.testing.assert_array_equal(ttta._batched_nms_numpy(boxes, scores, classes, t),
                                      jtta._batched_nms_numpy(boxes, scores, classes, t))


def test_tta_refuses_the_cpu_through_its_predictor(monkeypatch):
    from u2seg_torch.config import Config
    from u2seg_torch.engine.predictor import DefaultPredictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttta.TTAPredictor(DefaultPredictor(Config()))
