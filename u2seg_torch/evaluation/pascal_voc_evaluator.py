"""Pascal VOC box AP, the devkit's ``voc_eval`` (the 2007 11-point metric
or the area under the interpolated curve); counterpart of
``u2seg_tpu/evaluation/pascal_voc_evaluator.py``, after detectron2's
``evaluation/pascal_voc_evaluation.py``.
"""
from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional

import numpy as np

from u2seg_torch.evaluation.evaluator import DatasetEvaluator


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """AP from recall/precision arrays (devkit semantics)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval_class(
    gt_by_image: Dict, detections: List[dict], ovthresh: float = 0.5,
    use_07_metric: bool = False,
) -> float:
    """One class: gt_by_image maps image_id -> {"bbox" (G,4) XYXY,
    "difficult" (G,)}; detections are {"image_id","bbox" XYXY,"score"}."""
    npos = 0
    state = {}
    for img_id, g in gt_by_image.items():
        det_flags = np.zeros(len(g["bbox"]), bool)
        difficult = np.asarray(g["difficult"], bool)
        npos += int((~difficult).sum())
        state[img_id] = {
            "bbox": np.asarray(g["bbox"], np.float64).reshape(-1, 4),
            "difficult": difficult,
            "det": det_flags,
        }
    if npos == 0:
        return float("nan")
    dets = sorted(detections, key=lambda d: -d["score"])
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, det in enumerate(dets):
        g = state.get(det["image_id"])
        if g is None or len(g["bbox"]) == 0:
            fp[i] = 1
            continue
        bb = np.asarray(det["bbox"], np.float64)
        gt = g["bbox"]
        ixmin = np.maximum(gt[:, 0], bb[0])
        iymin = np.maximum(gt[:, 1], bb[1])
        ixmax = np.minimum(gt[:, 2], bb[2])
        iymax = np.minimum(gt[:, 3], bb[3])
        iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
        ih = np.maximum(iymax - iymin + 1.0, 0.0)
        inters = iw * ih
        uni = (
            (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
            + (gt[:, 2] - gt[:, 0] + 1.0) * (gt[:, 3] - gt[:, 1] + 1.0)
            - inters
        )
        overlaps = inters / np.maximum(uni, 1e-12)
        jmax = int(np.argmax(overlaps))
        if overlaps[jmax] > ovthresh:
            if not g["difficult"][jmax]:
                if not g["det"][jmax]:
                    tp[i] = 1
                    g["det"][jmax] = True
                else:
                    fp[i] = 1
        else:
            fp[i] = 1
    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(npos)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return voc_ap(rec, prec, use_07_metric)


class PascalVOCDetectionEvaluator(DatasetEvaluator):
    def __init__(self, class_names, year: int = 2012):
        self._class_names = list(class_names)
        self._use_07 = year == 2007
        self.reset()

    def reset(self):
        self._dets = defaultdict(list)          # class -> det records
        self._gt = defaultdict(dict)            # class -> image -> gt

    def process(self, inputs, outputs):
        for inp, out in zip(inputs, outputs):
            img_id = inp["image_id"]
            # accumulate gt
            for ann in inp.get("annotations", []):
                cls = ann["category_id"]
                x, y, w, h = ann["bbox"]
                g = self._gt[cls].setdefault(
                    img_id, {"bbox": [], "difficult": []}
                )
                g["bbox"].append([x, y, x + w, y + h])
                g["difficult"].append(ann.get("difficult", 0))
            inst = out.get("instances")
            if inst is None:
                continue
            boxes = np.asarray(inst["boxes"], np.float64)
            for box, score, cls in zip(
                boxes, inst["scores"], inst["classes"]
            ):
                self._dets[int(cls)].append({
                    "image_id": img_id, "bbox": box.tolist(),
                    "score": float(score),
                })

    def evaluate(self) -> Optional[dict]:
        aps = {}
        for thresh in (0.5, 0.75):
            vals = []
            for cls in range(len(self._class_names)):
                ap = voc_eval_class(
                    self._gt.get(cls, {}), self._dets.get(cls, []),
                    ovthresh=thresh, use_07_metric=self._use_07,
                )
                if not np.isnan(ap):
                    vals.append(ap)
            aps[thresh] = 100 * float(np.mean(vals)) if vals else 0.0
        return OrderedDict(bbox={
            "AP": (aps[0.5] + aps[0.75]) / 2, "AP50": aps[0.5], "AP75": aps[0.75],
        })
