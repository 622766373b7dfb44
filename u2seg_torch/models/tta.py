"""Test-time augmentation (counterpart of ``u2seg_tpu/models/tta.py``):
the predictor runs on the image resized to each of ``min_sizes`` (capped at
``max_size``) and, with ``flip``, on its mirror; the boxes are mapped back
to the original frame and merged by a class-aware greedy NMS on the host.

The resize is ``data.transforms.resize_bilinear_u8``, OpenCV's INTER_LINEAR
on uint8 bit for bit, where the JAX package calls ``cv2.resize``.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from u2seg_torch.data.transforms import resize_bilinear_u8


class TTAPredictor:
    def __init__(self, predictor,
                 min_sizes: Sequence[int] = (400, 500, 600, 700, 800, 900, 1000, 1100, 1200),
                 max_size: int = 4000, flip: bool = True, nms_thresh: float = 0.5,
                 max_detections: int = 100):
        """``predictor``: an ``engine.predictor.DefaultPredictor`` (or any
        callable image -> {"instances": {"boxes", "scores", "classes"}})."""
        self.predictor = predictor
        self.min_sizes = tuple(min_sizes)
        self.max_size = max_size
        self.flip = flip
        self.nms_thresh = nms_thresh
        self.max_detections = max_detections

    def __call__(self, img_rgb: np.ndarray) -> dict:
        oh, ow = img_rgb.shape[:2]
        all_boxes: List[np.ndarray] = []
        all_scores: List[np.ndarray] = []
        all_classes: List[np.ndarray] = []
        for size in self.min_sizes:
            scale = size / min(oh, ow)
            if max(oh, ow) * scale > self.max_size:
                scale = self.max_size / max(oh, ow)
            nh, nw = int(oh * scale + 0.5), int(ow * scale + 0.5)
            resized = resize_bilinear_u8(img_rgb, nh, nw)
            variants = [(resized, False)]
            if self.flip:
                variants.append((resized[:, ::-1].copy(), True))
            for img, flipped in variants:
                pred = self.predictor(img)["instances"]
                boxes = np.asarray(pred["boxes"], np.float64).copy()
                # the predictor answers in its input's frame (nh, nw)
                if flipped:
                    x0 = boxes[:, 0].copy()
                    boxes[:, 0] = nw - boxes[:, 2]
                    boxes[:, 2] = nw - x0
                boxes[:, 0::2] *= ow / nw
                boxes[:, 1::2] *= oh / nh
                all_boxes.append(boxes)
                all_scores.append(np.asarray(pred["scores"]))
                all_classes.append(np.asarray(pred["classes"]))

        boxes = np.concatenate(all_boxes) if all_boxes else np.zeros((0, 4))
        scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
        classes = np.concatenate(all_classes) if all_classes else np.zeros(0, np.int64)
        keep = _batched_nms_numpy(boxes, scores, classes, self.nms_thresh)
        keep = keep[: self.max_detections]
        return {"instances": {"boxes": boxes[keep], "scores": scores[keep],
                              "classes": classes[keep]}}


def _batched_nms_numpy(boxes, scores, classes, thresh) -> np.ndarray:
    """Greedy NMS in descending score order (stable); a box suppresses the
    boxes of its class that overlap it above ``thresh`` and score no higher."""
    order = np.argsort(-scores, kind="stable")
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    area = np.prod(np.clip(boxes[:, 2:] - boxes[:, :2], 0, None), axis=1)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        lt = np.maximum(boxes[i, :2], boxes[:, :2])
        rb = np.minimum(boxes[i, 2:], boxes[:, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[:, 0] * wh[:, 1]
        union = area[i] + area - inter
        iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0)
        suppressed |= (iou > thresh) & (classes == classes[i]) & (scores <= scores[i])
        suppressed[i] = True
    return np.asarray(keep, np.int64)
