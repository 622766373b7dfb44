"""Panoptic evaluator with U2Seg cluster remapping (counterpart of
``u2seg_tpu/evaluation/panoptic_evaluator.py``).

Thing segments are remapped through ``instance_mapping.json`` to real
dataset ids, stuff segments through ``semantic_mapping.json`` to ids
cluster_num+1..+15; unmatched segments are zeroed out of the id map. The
remap happens at ``evaluate()`` time, so that ``auto`` mode reads the
mappings the other two evaluators wrote in the same run.
"""
from __future__ import annotations

import logging
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from u2seg_torch.evaluation import hungarian
from u2seg_torch.evaluation.evaluator import DatasetEvaluator
from u2seg_torch.evaluation.panoptic_eval_core import pq_compute

logger = logging.getLogger(__name__)


class COCOPanopticEvaluator(DatasetEvaluator):
    def __init__(
        self,
        categories: Dict[int, dict],
        thing_contiguous_to_dataset: Dict[int, int],
        cluster_num: int = 800,
        matching_dir: str = "./hungarian_matching",
        mode: Optional[str] = None,          # None = auto-detect like the ref
        supervised: bool = False,
    ):
        self._categories = categories        # dataset_id -> {"isthing", ...}
        self._thing_c2d = thing_contiguous_to_dataset
        self._stuff_c2d = {i: cluster_num + i for i in range(1, 16)}
        self._stuff_c2d[0] = 0
        self.matching_dir = matching_dir
        self.supervised = supervised
        if mode is None and not supervised:
            sem_path = os.path.join(matching_dir, "semantic_mapping.json")
            mode = "eval" if os.path.exists(sem_path) else "hungarian_matching"
        self.mode = mode
        self._instance_mapping: Optional[Dict[int, int]] = None
        self._semantic_mapping: Optional[Dict[int, int]] = None
        self._predictions: List[Tuple[np.ndarray, List[dict]]] = []
        self._ground_truths: List[Tuple[np.ndarray, List[dict]]] = []

    def _load_mappings(self):
        if self._instance_mapping is None:
            self._instance_mapping = hungarian.load_mapping(
                os.path.join(self.matching_dir, "instance_mapping.json")
            )
            self._semantic_mapping = hungarian.load_mapping(
                os.path.join(self.matching_dir, "semantic_mapping.json")
            )

    def reset(self):
        self._predictions = []
        self._ground_truths = []

    def _convert_segment(self, seg: dict, pan: np.ndarray):
        """Remap one predicted segment's contiguous category to dataset ids;
        zero out unmatched segments (ref _convert_category_id :79-103)."""
        seg = dict(seg)
        isthing = seg.pop("isthing", None)
        if isthing is None or self.supervised:
            if isthing is True:
                seg["category_id"] = self._thing_c2d[seg["category_id"]]
            elif isthing is False:
                seg["category_id"] = self._stuff_c2d[seg["category_id"]]
            return seg, pan
        self._load_mappings()
        if isthing:
            mapped = self._instance_mapping.get(seg["category_id"], -1)
            if mapped == -1:
                pan[pan == seg["id"]] = 0
                return None, pan
            seg["category_id"] = self._thing_c2d[mapped]
        else:
            mapped = self._semantic_mapping.get(seg["category_id"], -1)
            if mapped == -1:
                pan[pan == seg["id"]] = 0
                return None, pan
            seg["category_id"] = self._stuff_c2d[mapped]
        return seg, pan

    def process(self, inputs, outputs):
        """inputs: [{"pan_gt": (H,W) ids, "gt_segments": [...]}];
        outputs: [{"panoptic": (H,W) ids,
                   "segments": [{"id","category_id","isthing"}...]}].

        Raw predictions are buffered; cluster->category conversion happens at
        evaluate() time so the single-pass 'auto' mode can consume mappings
        written by the instance/semantic evaluators in the same run."""
        for inp, out in zip(inputs, outputs):
            if out.get("panoptic") is None or inp.get("pan_gt") is None:
                continue
            self._predictions.append(
                (np.asarray(out["panoptic"]).copy(),
                 [dict(s) for s in out["segments"]])
            )
            self._ground_truths.append(
                (np.asarray(inp["pan_gt"]), list(inp["gt_segments"]))
            )

    def evaluate(self) -> Optional[dict]:
        if self.mode == "hungarian_matching" and not self.supervised:
            logger.info("panoptic evaluator idle during matching pass")
            return {}
        converted = []
        for pan, segments in self._predictions:
            out_segs: List[dict] = []
            for seg in segments:
                conv, pan = self._convert_segment(seg, pan)
                if conv is not None:
                    out_segs.append(conv)
            converted.append((pan, out_segs))
        res = pq_compute(self._ground_truths, converted, self._categories)
        out = OrderedDict()
        out["panoptic_seg"] = {
            "PQ": 100 * res["All"]["pq"],
            "SQ": 100 * res["All"]["sq"],
            "RQ": 100 * res["All"]["rq"],
            "PQ_th": 100 * res["Things"]["pq"],
            "SQ_th": 100 * res["Things"]["sq"],
            "RQ_th": 100 * res["Things"]["rq"],
            "PQ_st": 100 * res["Stuff"]["pq"],
            "SQ_st": 100 * res["Stuff"]["sq"],
            "RQ_st": 100 * res["Stuff"]["rq"],
        }
        return out
