"""COCO instance evaluator with U2Seg's cluster-matching protocol
(counterpart of ``u2seg_tpu/evaluation/coco_evaluator.py``).

The mapping is computed in-process; ``mode="auto"`` writes the matching
artifact and reports the metrics in one run, ``"hungarian_matching"`` and
``"eval"`` are the two passes of the reference's scheme.
"""
from __future__ import annotations

import copy
import logging
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from u2seg_torch.evaluation import hungarian
from u2seg_torch.evaluation.coco_api import COCO
from u2seg_torch.evaluation.coco_eval_core import COCOeval
from u2seg_torch.evaluation.evaluator import DatasetEvaluator

logger = logging.getLogger(__name__)


class COCOEvaluator(DatasetEvaluator):
    """Accumulates COCO-format detections; evaluates AP, optionally after
    cluster->class majority-vote matching.

    modes:
      "supervised"         — plain COCO AP (no matching).
      "hungarian_matching" — pass 1: compute + save mapping, skip metrics.
      "eval"               — pass 2: load mapping from disk, remap, AP.
      "auto"               — compute mapping AND metrics in one run.
    """

    def __init__(
        self,
        coco_gt: COCO,
        mode: str = "supervised",
        num_clusters: int = 800,
        tasks: Sequence[str] = ("bbox", "segm"),
        matching_dir: str = "./hungarian_matching",
        score_thresh: float = 0.6,
        iou_thresh: float = 0.7,
        max_dets: Sequence[int] = (1, 10, 100),
    ):
        self._coco_gt = coco_gt
        self.mode = mode
        self.num_clusters = num_clusters
        self.tasks = tuple(tasks)
        self.matching_dir = matching_dir
        self.score_thresh = score_thresh
        self.iou_thresh = iou_thresh
        self.max_dets = list(max_dets)
        self._predictions: List[dict] = []

    def reset(self):
        self._predictions = []

    def process(self, inputs, outputs):
        """inputs: [{"image_id", ...}]; outputs: [{"instances": {...}}] with
        instances = {"boxes" XYXY np, "scores", "classes", "rles" optional}."""
        for inp, out in zip(inputs, outputs):
            inst = out.get("instances")
            if inst is None:
                continue
            boxes = np.asarray(inst["boxes"], dtype=np.float64)
            scores = np.asarray(inst["scores"], dtype=np.float64)
            classes = np.asarray(inst["classes"], dtype=np.int64)
            rles = inst.get("rles")
            kpts = inst.get("keypoints")   # (K, 17, 3) x, y, score
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
                if kpts is not None:
                    # instances_to_coco_json shifts by 0.5 back to the
                    # pixel-corner convention (coco_evaluation.py:518-524)
                    kp = np.asarray(kpts[i], np.float64).copy()
                    kp[:, :2] -= 0.5
                    rec["keypoints"] = kp.reshape(-1).tolist()
                self._predictions.append(rec)

    # ------------------------------------------------------------------
    def _build_mapping(self, results: List[dict]) -> Dict[int, int]:
        meta_map = {
            ann_cat: i for i, ann_cat in enumerate(
                sorted({c["id"] for c in self._coco_gt.dataset["categories"]})
            )
        }
        gt_by_image = {
            img_id: anns for img_id, anns in self._coco_gt.imgToAnns.items()
        }
        pred_cl, gt_cl = hungarian.mine_instance_pairs(
            results, gt_by_image, meta_map,
            self.score_thresh, self.iou_thresh,
        )
        return hungarian.majority_vote_mapping(
            pred_cl, gt_cl, self.num_clusters, num_classes=len(meta_map)
        )

    def evaluate(self) -> Optional[dict]:
        results = copy.deepcopy(self._predictions)
        if not results:
            logger.warning("No predictions to evaluate")
            return {}

        if self.mode != "supervised":
            save_path = os.path.join(self.matching_dir, "instance_mapping.json")
            if self.mode in ("hungarian_matching", "auto"):
                mapping = self._build_mapping(results)
                hungarian.save_mapping(mapping, save_path)
                if self.mode == "hungarian_matching":
                    logger.info(
                        "Hungarian matching finished; mapping saved to %s",
                        save_path,
                    )
                    return {"instance_mapping": save_path}
            else:  # "eval"
                mapping = hungarian.load_mapping(save_path)
            cat_ids = sorted({c["id"] for c in self._coco_gt.dataset["categories"]})
            contiguous_to_dataset = {i: cid for i, cid in enumerate(cat_ids)}
            results = hungarian.remap_instance_results(
                results, mapping, contiguous_to_dataset
            )
            if not results:
                logger.warning("All predictions dropped by cluster mapping")
                return {}

        out = OrderedDict()
        for task in self.tasks:
            if task == "segm" and "segmentation" not in results[0]:
                continue
            if task == "keypoints" and "keypoints" not in results[0]:
                continue
            coco_dt = self._coco_gt.loadRes(results)
            E = COCOeval(self._coco_gt, coco_dt, iouType=task)
            if task != "keypoints":
                E.params.maxDets = self.max_dets
            E.evaluate()
            E.accumulate()
            stats = E.summarize()
            if task == "keypoints":
                out[task] = {
                    "AP": stats[0] * 100, "AP50": stats[1] * 100,
                    "AP75": stats[2] * 100, "APm": stats[3] * 100,
                    "APl": stats[4] * 100,
                }
            else:
                out[task] = {
                    "AP": stats[0] * 100, "AP50": stats[1] * 100,
                    "AP75": stats[2] * 100, "APs": stats[3] * 100,
                    "APm": stats[4] * 100, "APl": stats[5] * 100,
                }
        return out
