"""LVIS AP evaluation (counterpart of ``u2seg_tpu/evaluation/lvis_evaluator.py``,
after detectron2's ``evaluation/lvis_evaluation.py``) on the port's
``COCOeval`` core.
LVIS differs from COCO eval in: maxDets=300 with no [1,10] sweep, per-image
category exclusion via ``not_exhaustive_category_ids``/``neg_category_ids``
(dets for non-listed categories are neither TP nor FP), and APr/APc/APf
splits by category frequency.
"""
from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from u2seg_torch.evaluation.coco_api import COCO
from u2seg_torch.evaluation.coco_eval_core import COCOeval
from u2seg_torch.evaluation.evaluator import DatasetEvaluator


class LVISEval(COCOeval):
    """COCOeval specialization with LVIS semantics."""

    def __init__(self, gt: COCO, dt: COCO, iouType: str = "bbox"):
        super().__init__(gt, dt, iouType)
        self.params.maxDets = [300]
        # image -> categories that should be evaluated there
        self._img_nel: Dict[int, set] = {}
        for img_id, img in gt.imgs.items():
            pos = set()
            for ann in gt.imgToAnns[img_id]:
                pos.add(ann["category_id"])
            neg = set(img.get("neg_category_ids", []))
            # evaluate a category on an image iff it is positive or negative
            self._img_nel[img_id] = pos | neg

    def evaluateImg(self, imgId, catId, aRng, maxDet):
        # LVIS: skip (img, cat) pairs where the category is neither
        # exhaustively annotated nor negatively verified
        allowed = self._img_nel.get(imgId)
        if allowed is not None and catId not in allowed:
            return None
        return super().evaluateImg(imgId, catId, aRng, maxDet)

    def summarize_lvis(self, cat_frequency: Dict[int, str]):
        p = self.params
        prec = self.eval["precision"]  # T, R, K, A, M

        def ap_for(cat_idx_mask=None, iou_thr=None):
            s = prec[:, :, :, 0, -1]  # area 'all', maxDet 300
            if iou_thr is not None:
                t = np.where(np.isclose(p.iouThrs, iou_thr))[0]
                s = s[t]
            if cat_idx_mask is not None:
                s = s[..., cat_idx_mask]
            valid = s[s > -1]
            return float(np.mean(valid)) if valid.size else float("nan")

        freq = [cat_frequency.get(c, "f") for c in p.catIds]
        rare = np.array([f == "r" for f in freq])
        common = np.array([f == "c" for f in freq])
        frequent = np.array([f == "f" for f in freq])
        return {
            "AP": ap_for() * 100,
            "AP50": ap_for(iou_thr=0.5) * 100,
            "AP75": ap_for(iou_thr=0.75) * 100,
            "APr": ap_for(rare) * 100,
            "APc": ap_for(common) * 100,
            "APf": ap_for(frequent) * 100,
        }


class LVISEvaluator(DatasetEvaluator):
    def __init__(self, lvis_gt: COCO, tasks: Sequence[str] = ("bbox", "segm")):
        self._gt = lvis_gt
        self.tasks = tuple(tasks)
        self._predictions: List[dict] = []
        # frequency bands from the category table (LVIS v1: "frequency" key)
        self._freq = {
            c["id"]: c.get("frequency", "f")
            for c in lvis_gt.dataset.get("categories", [])
        }

    def reset(self):
        self._predictions = []

    def process(self, inputs, outputs):
        for inp, out in zip(inputs, outputs):
            inst = out.get("instances")
            if inst is None:
                continue
            boxes = np.asarray(inst["boxes"], np.float64)
            scores = np.asarray(inst["scores"], np.float64)
            classes = np.asarray(inst["classes"], np.int64)
            rles = inst.get("rles")
            for i in range(len(scores)):
                x0, y0, x1, y1 = boxes[i]
                rec = {
                    "image_id": inp["image_id"],
                    "category_id": int(classes[i]),
                    "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                    "score": float(scores[i]),
                }
                if rles is not None:
                    rec["segmentation"] = rles[i]
                self._predictions.append(rec)

    def evaluate(self) -> Optional[dict]:
        if not self._predictions:
            return {}
        out = OrderedDict()
        for task in self.tasks:
            if task == "segm" and "segmentation" not in self._predictions[0]:
                continue
            dt = self._gt.loadRes(copy.deepcopy(self._predictions))
            E = LVISEval(self._gt, dt, iouType=task)
            E.evaluate()
            E.accumulate()
            out[task] = E.summarize_lvis(self._freq)
        return out
