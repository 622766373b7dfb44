"""Cityscapes instance and semantic evaluation (counterpart of
``u2seg_tpu/evaluation/cityscapes_evaluator.py``, after detectron2's
``evaluation/cityscapes_evaluation.py``, which shells out to
cityscapesscripts). Mask predictions are scored with the official protocol
re-derived in ``evaluation/cityscapes_instance_ap.py``
(confidence-weighted duplicate matching, group/undersized-GT ignore regions, hard false negatives,
centered-step AP integration). Box-only predictions fall back to the
COCOeval core. The semantic evaluator is the standard 19-class
confusion-matrix mIoU.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional

import numpy as np

from u2seg_torch.data.cityscapes import (
    CITYSCAPES_SEM_CLASSES, CITYSCAPES_THING_CLASSES,
)
from u2seg_torch.evaluation import rle as rle_codec
from u2seg_torch.evaluation.cityscapes_instance_ap import evaluate_instance_ap
from u2seg_torch.evaluation.coco_api import COCO
from u2seg_torch.evaluation.coco_eval_core import COCOeval
from u2seg_torch.evaluation.evaluator import DatasetEvaluator
from u2seg_torch.evaluation.sem_seg_evaluator import SemSegEvaluator


class CityscapesInstanceEvaluator(DatasetEvaluator):
    """Mask AP over the 8 cityscapes thing classes: official protocol on
    masks (cityscapes_instance_ap.py), COCOeval core on boxes."""

    def __init__(self, dataset_dicts: List[dict]):
        self._dicts = {d["image_id"]: d for d in dataset_dicts}
        # build a COCO-format GT index from the loaded dicts
        images, anns = [], []
        aid = 1
        for d in dataset_dicts:
            images.append({
                "id": d["image_id"], "height": d["height"], "width": d["width"],
            })
            for a in d.get("annotations", []):
                r = dict(a)
                r["id"] = aid
                r["image_id"] = d["image_id"]
                aid += 1
                anns.append(r)
        self._gt = COCO({
            "images": images,
            "annotations": anns,
            "categories": [
                {"id": i, "name": n}
                for i, n in enumerate(CITYSCAPES_THING_CLASSES)
            ],
        })
        self._predictions: List[dict] = []

    def reset(self):
        self._predictions = []

    def process(self, inputs, outputs):
        for inp, out in zip(inputs, outputs):
            inst = out.get("instances")
            if inst is None:
                continue
            boxes = np.asarray(inst["boxes"], np.float64)
            for i in range(len(inst["scores"])):
                x0, y0, x1, y1 = boxes[i]
                rec = {
                    "image_id": inp["image_id"],
                    "category_id": int(inst["classes"][i]),
                    "bbox": [x0, y0, x1 - x0, y1 - y0],
                    "score": float(inst["scores"][i]),
                }
                rles = inst.get("rles")
                if rles is not None:
                    rec["segmentation"] = rles[i]
                self._predictions.append(rec)

    def evaluate(self) -> Optional[dict]:
        if not self._predictions:
            return {}
        if "segmentation" in self._predictions[0]:
            return self._evaluate_official()
        dt = self._gt.loadRes(list(self._predictions))
        E = COCOeval(self._gt, dt, iouType="bbox")
        E.evaluate()
        E.accumulate()
        stats = E.summarize()
        return OrderedDict(
            cityscapes_instance={"AP": stats[0] * 100, "AP50": stats[1] * 100}
        )

    def _evaluate_official(self) -> dict:
        """Official-protocol mask AP (ref cityscapes_evaluation.py:197 ->
        cityscapesscripts evalInstanceLevelSemanticLabeling)."""
        gt_by_image, pred_by_image = {}, {}
        for img_id, d in self._dicts.items():
            gts = []
            for a in d.get("annotations", []):
                seg = a.get("segmentation")
                if seg is None:
                    continue
                gts.append({
                    "mask": rle_codec.decode(seg).astype(bool),
                    "class": int(a["category_id"]),
                    "ignore": bool(a.get("iscrowd", 0)),
                })
            gt_by_image[img_id] = gts
        for rec in self._predictions:
            pred_by_image.setdefault(rec["image_id"], []).append({
                "mask": rle_codec.decode(rec["segmentation"]).astype(bool),
                "class": int(rec["category_id"]),
                "score": float(rec["score"]),
            })
        res = evaluate_instance_ap(
            gt_by_image, pred_by_image,
            num_classes=len(CITYSCAPES_THING_CLASSES),
        )
        return OrderedDict(cityscapes_instance={
            "AP": res["AP"] * 100, "AP50": res["AP50"] * 100,
        })


class CityscapesSemSegEvaluator(SemSegEvaluator):
    """19-class mIoU (the official cityscapes semantic metric)."""

    def __init__(self):
        super().__init__(
            mode="supervised",
            num_pred_classes=len(CITYSCAPES_SEM_CLASSES),
            ignore_label=255,
        )

    def evaluate(self):
        out = super().evaluate()
        return OrderedDict(cityscapes_sem_seg=out["sem_seg"])
