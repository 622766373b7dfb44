"""Visualization demo helpers and a pipelined predictor (counterpart of
``demo/predictor.py`` and of ``VisualizationDemo`` in ``demo/u2seg_demo.py``,
after the reference ``demo/predictor.py``: VisualizationDemo :15,
AsyncPredictor :132).

``VisualizationDemo`` predicts with ``engine.predictor.DefaultPredictor``
(on ``cuda`` unless a device is named), remaps the cluster ids of the
panoptic segments through the Hungarian instance mapping when one is given
(``evaluation/hungarian.load_mapping``), and draws with the OpenCV-free
``utils.visualizer``. ``run_on_video`` is the per-frame loop over an iterable
of RGB frames: predict, ``tracker.update``, ``VideoVisualizer``.
``AsyncPredictor`` runs the predictor in a worker thread, so the host decodes
the next frame while the card runs the current one.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Iterable, Iterator, Tuple

import numpy as np


class VisualizationDemo:
    def __init__(self, cfg, matching_dir: str = "", parallel: bool = False,
                 device=None, model=None):
        from u2seg_torch.data.catalog import MetadataCatalog
        from u2seg_torch.engine.predictor import DefaultPredictor

        self.predictor = (AsyncPredictor(cfg, device=device, model=model) if parallel
                          else DefaultPredictor(cfg, model=model, device=device))
        self.metadata = MetadataCatalog.get("__demo__")
        self.text_boxes = []          # the label boxes of the last drawing
        self.instance_mapping = None
        if matching_dir:
            from u2seg_torch.evaluation import hungarian

            self.instance_mapping = hungarian.load_mapping(
                os.path.join(matching_dir, "instance_mapping.json"))

    def draw(self, img_rgb: np.ndarray, predictions: dict):
        """The drawing alone: the Visualizer over ``predictions``."""
        from u2seg_torch.utils.visualizer import Visualizer

        vis = Visualizer(img_rgb, self.metadata)
        if "panoptic" in predictions:
            segments = predictions["segments"]
            if self.instance_mapping is not None:
                segments = [
                    dict(s, category_id=self.instance_mapping.get(
                        s["category_id"], s["category_id"]))
                    for s in segments
                ]
            vis.draw_panoptic_seg(predictions["panoptic"], segments)
        else:
            vis.draw_instance_predictions(predictions["instances"])
        self.text_boxes = vis.text_boxes
        return vis.img

    def run_on_image(self, img_rgb: np.ndarray) -> Tuple[dict, np.ndarray]:
        predictions = self.predictor(img_rgb)
        return predictions, self.draw(img_rgb, predictions)

    def run_on_video(self, frames: Iterable[np.ndarray],
                     tracker=None) -> Iterator[Tuple[dict, np.ndarray, np.ndarray]]:
        """Per frame of ``frames`` (RGB uint8): (predictions, track ids, the
        frame drawn by ``VideoVisualizer`` with colors per track)."""
        from u2seg_torch.utils.tracking import BBoxIOUTracker
        from u2seg_torch.utils.visualizer import VideoVisualizer

        tracker = tracker or BBoxIOUTracker()
        vvis = VideoVisualizer(self.metadata)
        for rgb in frames:
            predictions = self.predictor(rgb)
            inst = predictions["instances"]
            ids = tracker.update(inst)
            drawn = vvis.draw_instance_predictions(rgb, inst, ids)
            self.text_boxes = vvis.text_boxes
            yield predictions, ids, drawn


class AsyncPredictor:
    """Thread-pipelined predictor: ``put()`` frames, ``get()`` results in
    order (ref predictor.py:132 starts a process per GPU; one worker thread
    suffices here: CUDA launches are asynchronous, and the thread overlaps the
    host's decoding and post-processing with the card's forward)."""

    def __init__(self, cfg, queue_size: int = 3, device=None, model=None):
        from u2seg_torch.engine.predictor import DefaultPredictor

        self._task_q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._result_q: "queue.Queue" = queue.Queue()
        self._predictor = DefaultPredictor(cfg, model=model, device=device)
        self._put_idx = 0
        self._get_idx = 0
        self._buffer = {}
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._task_q.get()
            if item is None:
                return
            idx, image = item
            try:
                result = self._predictor(image)
            except Exception as e:  # handed to get(), which raises it
                result = e
            self._result_q.put((idx, result))

    def put(self, image: np.ndarray):
        self._task_q.put((self._put_idx, image))
        self._put_idx += 1

    def get(self):
        while self._get_idx not in self._buffer:
            idx, res = self._result_q.get()
            self._buffer[idx] = res
        out = self._buffer.pop(self._get_idx)
        self._get_idx += 1
        if isinstance(out, Exception):
            raise out
        return out

    def __call__(self, image: np.ndarray):
        self.put(image)
        return self.get()

    def shutdown(self):
        self._task_q.put(None)
        self._thread.join(timeout=10)

    def __len__(self):
        return self._put_idx - self._get_idx
