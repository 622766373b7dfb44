"""Rotated-box COCO evaluation (counterpart of
``u2seg_tpu/evaluation/rotated_coco_evaluator.py``; detectron2's
``evaluation/rotated_coco_evaluation.py``): COCO-style AP where detections
and ground truth are (cx, cy, w, h, angle) boxes and the IoU is the exact
rotated-box IoU. bbox task only; crowd regions are refused, as in the
reference.

The IoU here is a host-side numpy Sutherland-Hodgman clip in f64, the twin
of ``structures.rotated_boxes.pairwise_iou_rotated`` (evaluation is host
work).
"""
from __future__ import annotations

import copy
from collections import OrderedDict

import numpy as np

from u2seg_torch.evaluation.coco_eval_core import COCOeval
from u2seg_torch.evaluation.coco_evaluator import COCOEvaluator


def _corners(boxes: np.ndarray) -> np.ndarray:
    """(N, 5) XYWHA -> (N, 4, 2) corners: ``centre + [[c, s], [-s, c]] @ d``."""
    cx, cy, w, h, a = [boxes[:, i] for i in range(5)]
    t = np.deg2rad(a)
    c, s = np.cos(t), np.sin(t)
    dx = np.stack([-w / 2, w / 2, w / 2, -w / 2], 1)
    dy = np.stack([-h / 2, -h / 2, h / 2, h / 2], 1)
    x = cx[:, None] + dx * c[:, None] + dy * s[:, None]
    y = cy[:, None] - dx * s[:, None] + dy * c[:, None]
    return np.stack([x, y], axis=-1)


def _poly_area(p: np.ndarray) -> float:
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _clip_poly(subject: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Clip a polygon by the half-plane left of the directed edge a -> b."""
    if len(subject) == 0:
        return subject
    d = b - a
    side = (subject[:, 0] - a[0]) * d[1] - (subject[:, 1] - a[1]) * d[0]
    out = []
    n = len(subject)
    for i in range(n):
        j = (i + 1) % n
        if side[i] <= 0:
            out.append(subject[i])
        if (side[i] <= 0) != (side[j] <= 0):
            t = side[i] / (side[i] - side[j])
            out.append(subject[i] + t * (subject[j] - subject[i]))
    return np.asarray(out) if out else np.zeros((0, 2))


def rotated_iou_numpy(dt: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Exact pairwise IoU of XYWHA boxes, (D, G), in f64."""
    dt = np.asarray(dt, np.float64).reshape(-1, 5)
    gt = np.asarray(gt, np.float64).reshape(-1, 5)
    dcs, gcs = _corners(dt), _corners(gt)
    dareas, gareas = dt[:, 2] * dt[:, 3], gt[:, 2] * gt[:, 3]
    out = np.zeros((len(dt), len(gt)))
    for i, dc in enumerate(dcs):
        for j, gc in enumerate(gcs):
            poly = dc
            for k in range(4):
                poly = _clip_poly(poly, gc[k], gc[(k + 1) % 4])
                if len(poly) == 0:
                    break
            inter = _poly_area(poly) if len(poly) >= 3 else 0.0
            union = dareas[i] + gareas[j] - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


class RotatedCOCOeval(COCOeval):
    """COCOeval whose bbox IoU takes 5-dim rotated boxes; 4-dim XYWH boxes
    become XYWHA with angle 0."""

    @staticmethod
    def _to_xywha(arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr, np.float64)
        if arr.size == 0:
            return arr.reshape(0, 5)
        if arr.shape[1] == 5:
            return arr
        x, y, w, h = arr.T
        return np.stack([x + w / 2, y + h / 2, w, h, np.zeros_like(x)], 1)

    def computeIoU(self, imgId, catId):
        p = self.params
        assert p.iouType == "bbox", "RotatedCOCOeval supports bbox only"
        gt = self._gts[imgId, catId] if p.useCats else [
            g for c in p.catIds for g in self._gts[imgId, c]]
        dt = self._dts[imgId, catId] if p.useCats else [
            d for c in p.catIds for d in self._dts[imgId, c]]
        if len(gt) == 0 or len(dt) == 0:
            return np.zeros((0, 0))
        inds = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in inds][: p.maxDets[-1]]
        assert all(int(g.get("iscrowd", 0)) == 0 for g in gt), \
            "crowd regions are not supported for rotated boxes"
        d = self._to_xywha(np.array([d_["bbox"] for d_ in dt]))
        g = self._to_xywha(np.array([g_["bbox"] for g_ in gt]))
        return rotated_iou_numpy(d, g)


class RotatedCOCOEvaluator(COCOEvaluator):
    """COCOEvaluator for rotated detections: the instances carry (N, 5)
    XYWHA boxes (or (N, 4) XYXY ones, converted to XYWH), only the bbox task
    runs, and the IoU is rotated-exact."""

    def __init__(self, coco_gt, **kwargs):
        kwargs.setdefault("tasks", ("bbox",))
        super().__init__(coco_gt, **kwargs)
        assert set(self.tasks) == {"bbox"}, \
            "[RotatedCOCOEvaluator] Only bbox evaluation is supported"

    def process(self, inputs, outputs):
        for inp, out in zip(inputs, outputs):
            inst = out.get("instances")
            if inst is None:
                continue
            boxes = np.asarray(inst["boxes"], dtype=np.float64)
            scores = np.asarray(inst["scores"], dtype=np.float64)
            classes = np.asarray(inst["classes"], dtype=np.int64)
            for i in range(len(scores)):
                if boxes.shape[1] == 5:
                    bb = [float(v) for v in boxes[i]]
                else:
                    x0, y0, x1, y1 = boxes[i]
                    bb = [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]
                self._predictions.append({
                    "image_id": inp["image_id"], "category_id": int(classes[i]),
                    "bbox": bb, "score": float(scores[i])})

    def evaluate(self):
        results = copy.deepcopy(self._predictions)
        if not results:
            return {}
        coco_dt = self._coco_gt.loadRes(results)
        E = RotatedCOCOeval(self._coco_gt, coco_dt, iouType="bbox")
        E.params.maxDets = self.max_dets
        E.evaluate()
        E.accumulate()
        stats = E.summarize()
        return OrderedDict(bbox={
            "AP": stats[0] * 100, "AP50": stats[1] * 100, "AP75": stats[2] * 100,
            "APs": stats[3] * 100, "APm": stats[4] * 100, "APl": stats[5] * 100})
