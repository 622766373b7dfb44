"""The port's trackers (``u2seg_torch/utils/tracking.py``) against the JAX
package's, on seeded sequences of detections: boxes that drift, vanish,
reappear and change class, and frames with no detection. Exact: the track
ids of every frame are equal.
"""
import numpy as np
import pytest

from u2seg_tpu.utils import tracking as jtracking
from u2seg_torch.utils import tracking


def sequence(seed: int, frames: int = 12, objects: int = 6):
    rng = np.random.RandomState(seed)
    xy = rng.rand(objects, 2) * 200
    wh = rng.rand(objects, 2) * 60 + 10
    cls = rng.randint(0, 3, objects)
    out = []
    for t in range(frames):
        xy = xy + rng.randn(objects, 2) * 4
        keep = rng.rand(objects) > 0.25
        if t % 5 == 4:
            keep[:] = False                      # an empty frame
        boxes = np.concatenate([xy, xy + wh], 1)[keep]
        classes = np.where(rng.rand(objects) > 0.9, (cls + 1) % 3, cls)[keep]
        order = rng.permutation(int(keep.sum()))  # detection order shuffles
        out.append({"boxes": boxes[order], "scores": rng.rand(len(order)),
                    "classes": classes[order]})
    return out


@pytest.mark.parametrize("name", ["BBoxIOUTracker", "VanillaHungarianBBoxIOUTracker",
                                  "IOUWeightedHungarianBBoxIOUTracker"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_track_ids_equal_the_jax_trackers(name, seed):
    assert sorted(tracking.TRACKER_REGISTRY) == sorted(jtracking.TRACKER_REGISTRY)
    kw = {"track_iou_threshold": 0.3}
    port = tracking.build_tracker_head(name, **kw)
    ref = jtracking.build_tracker_head(name, **kw)
    reused = 0
    for frame in sequence(seed):
        got, want = port.update(frame), ref.update(frame)
        np.testing.assert_array_equal(got, want)
        reused += int(np.isin(got, np.arange(port._next_id - len(got))).sum())
    assert reused > 0                             # some tracks carried over
