"""Video object trackers: stable instance ids across frames (the port's copy
of ``u2seg_tpu/utils/tracking.py``, numpy plus scipy's
``linear_sum_assignment``; the same detections give the same ids).

Counterpart of ``detectron2/tracking/`` (BaseTracker+registry
base_tracker.py:15,53; BBoxIOUTracker bbox_iou_tracker.py:17;
BaseHungarianTracker hungarian_tracker.py:16 with scipy
linear_sum_assignment; VanillaHungarianBBoxIOUTracker;
IOUWeightedHungarianBBoxIOUTracker). Operates on plain numpy detections
dicts {"boxes" XYXY, "scores", "classes"} and returns per-frame track ids.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

TRACKER_REGISTRY: Dict[str, type] = {}


def register_tracker(name: str):
    def deco(cls):
        TRACKER_REGISTRY[name] = cls
        return cls

    return deco


def build_tracker_head(name: str, **kwargs) -> "BaseTracker":
    return TRACKER_REGISTRY[name](**kwargs)


def _pairwise_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), -1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), -1)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class BaseTracker:
    def __init__(self):
        self._prev_boxes: Optional[np.ndarray] = None
        self._prev_classes: Optional[np.ndarray] = None
        self._prev_ids: Optional[np.ndarray] = None
        self._prev_lost: Optional[np.ndarray] = None
        self._next_id = 0

    def _new_ids(self, n: int) -> np.ndarray:
        ids = np.arange(self._next_id, self._next_id + n)
        self._next_id += n
        return ids

    def update(self, instances: dict) -> np.ndarray:
        raise NotImplementedError


@register_tracker("BBoxIOUTracker")
class BBoxIOUTracker(BaseTracker):
    """Greedy IoU matching to the previous frame (ref bbox_iou_tracker.py:17).
    Tracks survive ``max_lost_frames`` misses."""

    def __init__(self, track_iou_threshold: float = 0.5,
                 max_lost_frames: int = 5):
        super().__init__()
        self.iou_threshold = track_iou_threshold
        self.max_lost = max_lost_frames

    def _assign(self, iou: np.ndarray):
        """Returns cur_idx -> prev_idx map (greedy by IoU desc)."""
        match = {}
        if iou.size == 0:
            return match
        flat = [
            (iou[i, j], i, j)
            for i in range(iou.shape[0]) for j in range(iou.shape[1])
            if iou[i, j] >= self.iou_threshold
        ]
        used_i, used_j = set(), set()
        for v, i, j in sorted(flat, key=lambda t: -t[0]):
            if i in used_i or j in used_j:
                continue
            match[i] = j
            used_i.add(i)
            used_j.add(j)
        return match

    def update(self, instances: dict) -> np.ndarray:
        boxes = np.asarray(instances["boxes"], np.float64).reshape(-1, 4)
        classes = np.asarray(
            instances.get("classes", np.zeros(len(boxes))), np.int64
        )
        if self._prev_boxes is None or len(self._prev_boxes) == 0:
            ids = self._new_ids(len(boxes))
        else:
            iou = _pairwise_iou_xyxy(boxes, self._prev_boxes)
            same_cls = classes[:, None] == self._prev_classes[None, :]
            iou = np.where(same_cls, iou, 0.0)
            match = self._assign(iou)
            ids = np.empty(len(boxes), np.int64)
            for i in range(len(boxes)):
                if i in match:
                    ids[i] = self._prev_ids[match[i]]
                else:
                    ids[i] = self._new_ids(1)[0]
        self._remember(boxes, classes, ids)
        return ids

    def _remember(self, boxes, classes, ids):
        # carry forward recently-lost tracks so they can be re-acquired
        if self._prev_boxes is not None and len(self._prev_boxes):
            lost_mask = ~np.isin(self._prev_ids, ids)
            lost_age = self._prev_lost[lost_mask] + 1
            keep = lost_age <= self.max_lost
            boxes = np.concatenate([boxes, self._prev_boxes[lost_mask][keep]])
            classes = np.concatenate([classes, self._prev_classes[lost_mask][keep]])
            ids = np.concatenate([ids, self._prev_ids[lost_mask][keep]])
            lost = np.concatenate([
                np.zeros(len(ids) - int(keep.sum()), np.int64),
                lost_age[keep],
            ])
        else:
            lost = np.zeros(len(ids), np.int64)
        self._prev_boxes = boxes
        self._prev_classes = classes
        self._prev_ids = ids
        self._prev_lost = lost


class BaseHungarianTracker(BaseTracker):
    """Optimal assignment via scipy linear_sum_assignment
    (ref hungarian_tracker.py:16)."""

    def __init__(self, track_iou_threshold: float = 0.5):
        super().__init__()
        self.iou_threshold = track_iou_threshold

    def build_cost_matrix(self, iou: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def update(self, instances: dict) -> np.ndarray:
        from scipy.optimize import linear_sum_assignment

        boxes = np.asarray(instances["boxes"], np.float64).reshape(-1, 4)
        classes = np.asarray(
            instances.get("classes", np.zeros(len(boxes))), np.int64
        )
        if self._prev_boxes is None or len(self._prev_boxes) == 0 or len(boxes) == 0:
            ids = self._new_ids(len(boxes))
        else:
            iou = _pairwise_iou_xyxy(boxes, self._prev_boxes)
            same_cls = classes[:, None] == self._prev_classes[None, :]
            iou = np.where(same_cls, iou, 0.0)
            cost = self.build_cost_matrix(iou)
            rows, cols = linear_sum_assignment(cost)
            ids = np.full(len(boxes), -1, np.int64)
            for i, j in zip(rows, cols):
                if iou[i, j] >= self.iou_threshold:
                    ids[i] = self._prev_ids[j]
            for i in range(len(boxes)):
                if ids[i] < 0:
                    ids[i] = self._new_ids(1)[0]
        self._prev_boxes = boxes
        self._prev_classes = classes
        self._prev_ids = ids
        self._prev_lost = np.zeros(len(ids), np.int64)
        return ids


@register_tracker("VanillaHungarianBBoxIOUTracker")
class VanillaHungarianBBoxIOUTracker(BaseHungarianTracker):
    def build_cost_matrix(self, iou: np.ndarray) -> np.ndarray:
        # cost = 1 where IoU above threshold would allow a match, else big
        return np.where(iou >= self.iou_threshold, 1.0 - 0.5 * iou, 1e6)


@register_tracker("IOUWeightedHungarianBBoxIOUTracker")
class IOUWeightedHungarianBBoxIOUTracker(BaseHungarianTracker):
    def build_cost_matrix(self, iou: np.ndarray) -> np.ndarray:
        return np.where(iou >= self.iou_threshold, 1.0 - iou, 1e6)
