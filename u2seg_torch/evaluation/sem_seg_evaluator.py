"""Semantic segmentation evaluator with U2Seg's supercategory matching
(counterpart of ``u2seg_tpu/evaluation/sem_seg_evaluator.py``).

GT contiguous-stuff maps are transferred to 15 supercategories + 0 (things)
+ 255 (ignore); in the matching pass, predicted stuff clusters vote for
supercategories via mask IoU > 0.15; in the eval pass, predictions are
remapped and scored with a 16+1 confusion matrix (mIoU / fwIoU / mACC /
pACC) plus per-class Boundary IoU, computed, as the reference does, by
eroding the *label map* and differencing.

Boundary IoU needs no OpenCV here, so the port always reports it; the JAX
package drops it when cv2 is missing.
"""
from __future__ import annotations

import logging
import os
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from u2seg_torch.data.builtin_meta import (
    NUM_SUPERCATEGORIES,
    contiguous_stuff_to_supercategory,
)
from u2seg_torch.evaluation import hungarian
from u2seg_torch.evaluation.evaluator import DatasetEvaluator

logger = logging.getLogger(__name__)


def mask_to_boundary(mask: np.ndarray, dilation_ratio: float = 0.02
                     ) -> np.ndarray:
    """Boundary band of a uint8 label map: the map minus its erosion
    (the reference pads 1 px of zeros and runs ``cv2.erode`` with a 3x3
    kernel round(0.02 * diagonal) times; the padded border itself never
    erodes). k 3x3 erosions compose into one (2k+1)-square minimum, and the
    zero ring makes every window that leaves the map take 0, so this is a
    min filter over the map padded with zeros, run as two separable passes
    of ``max_pool2d`` on the negated map. Like the reference it works on
    label values, not on one class at a time."""
    assert mask.ndim == 2
    h, w = mask.shape
    k = max(1, int(round(dilation_ratio * np.sqrt(h ** 2 + w ** 2))))
    x = torch.from_numpy(np.ascontiguousarray(mask, np.float32))[None, None]
    x = F.pad(x, (k, k, k, k), value=0.0)
    x = -F.max_pool2d(-x, (2 * k + 1, 1), stride=1)
    eroded = -F.max_pool2d(-x, (1, 2 * k + 1), stride=1)
    return mask - eroded[0, 0].numpy().astype(mask.dtype)


def transfer_gt_to_supercategories(gt: np.ndarray) -> np.ndarray:
    """133-class contiguous stuff GT (0=things, 1..53 stuff, 255 ignore) ->
    16 classes (0=things, 1..15 supercats, 255 ignore). (ref transfer())"""
    mapping = contiguous_stuff_to_supercategory()
    out = gt.copy()
    for cont_id, super_id in mapping.items():
        out[gt == cont_id] = super_id
    return out


class SemSegEvaluator(DatasetEvaluator):
    """modes: "supervised" (plain mIoU on num_classes),
    "hungarian_matching" / "eval" / "auto" (U2Seg protocol on 16 classes)."""

    def __init__(
        self,
        mode: str = "supervised",
        num_pred_classes: int = 28,
        num_classes: int = 16,
        ignore_label: int = 255,
        matching_dir: str = "./hungarian_matching",
        iou_thresh: float = 0.15,
    ):
        self.mode = mode
        self.num_pred_classes = num_pred_classes
        # U2Seg forces 16 (= 15 supercats + things slot 0), ref :131
        self._num_classes = (
            num_classes if mode != "supervised" else num_pred_classes
        )
        self._ignore_label = ignore_label
        self.matching_dir = matching_dir
        self.iou_thresh = iou_thresh
        # the boundary works on uint8 label maps (ref :109-120)
        self._compute_boundary_iou = self._num_classes < np.iinfo(np.uint8).max
        self.reset()

    def reset(self):
        self._conf_matrix = np.zeros(
            (self._num_classes + 1, self._num_classes + 1), dtype=np.int64
        )
        self._b_conf_matrix = np.zeros_like(self._conf_matrix)
        self._pred_votes: List[int] = []
        self._gt_votes: List[int] = []
        self._pairs: List = []  # (pred, gt) per image when mode == auto

    def process(self, inputs, outputs):
        """inputs: [{"sem_seg_gt": (H,W) np}], outputs: [{"sem_seg": (H,W)}].
        For the unsupervised protocol, sem_seg_gt must already be the
        contiguous-stuff encoding (0 things / 1..53 stuff / 255 ignore)."""
        for inp, out in zip(inputs, outputs):
            if out.get("sem_seg") is None or inp.get("sem_seg_gt") is None:
                continue
            pred = np.asarray(out["sem_seg"], dtype=np.int64)
            gt = np.asarray(inp["sem_seg_gt"], dtype=np.int64)
            if self.mode == "supervised":
                self._accumulate_conf(pred, gt)
                continue
            gt_super = transfer_gt_to_supercategories(gt)
            if self.mode in ("hungarian_matching", "auto"):
                p, g = hungarian.mine_semantic_pairs(
                    pred, gt_super, self.iou_thresh
                )
                self._pred_votes.extend(p)
                self._gt_votes.extend(g)
            if self.mode in ("eval", "auto"):
                self._pairs.append((pred, gt_super))

    def _accumulate_conf(self, pred: np.ndarray, gt: np.ndarray):
        n = self._num_classes
        pred = pred.copy()
        pred[pred >= n] = n  # out-of-range -> extra bin
        gt2 = gt.copy()
        gt2[gt2 == self._ignore_label] = n
        gt2[gt2 > n] = n
        self._conf_matrix += np.bincount(
            (n + 1) * pred.reshape(-1) + gt2.reshape(-1),
            minlength=self._conf_matrix.size,
        ).reshape(self._conf_matrix.shape)
        if self._compute_boundary_iou:
            # ref :269-277: boundary confusion on eroded label maps
            b_pred = mask_to_boundary(pred.astype(np.uint8)).astype(np.int64)
            b_gt = mask_to_boundary(gt2.astype(np.uint8)).astype(np.int64)
            self._b_conf_matrix += np.bincount(
                (n + 1) * np.minimum(b_pred, n).reshape(-1)
                + np.minimum(b_gt, n).reshape(-1),
                minlength=self._b_conf_matrix.size,
            ).reshape(self._b_conf_matrix.shape)

    def _metrics_from_conf(self) -> dict:
        """mIoU/fwIoU/mACC/pACC from the confusion matrix (ref :320-372)."""
        n = self._num_classes
        acc = np.full(n, np.nan, dtype=np.float64)
        iou = np.full(n, np.nan, dtype=np.float64)
        tp = self._conf_matrix.diagonal()[:-1].astype(np.float64)
        pos_gt = np.sum(self._conf_matrix[:-1, :-1], axis=0).astype(np.float64)
        class_weights = pos_gt / np.maximum(np.sum(pos_gt), 1)
        pos_pred = np.sum(self._conf_matrix[:-1, :-1], axis=1).astype(np.float64)
        acc_valid = pos_gt > 0
        acc[acc_valid] = tp[acc_valid] / pos_gt[acc_valid]
        union = pos_gt + pos_pred - tp
        iou_valid = np.logical_and(acc_valid, union > 0)
        iou[iou_valid] = tp[iou_valid] / union[iou_valid]
        macc = np.sum(acc[acc_valid]) / max(np.sum(acc_valid), 1)
        miou = np.sum(iou[iou_valid]) / max(np.sum(iou_valid), 1)
        fiou = np.sum(iou[iou_valid] * class_weights[iou_valid])
        pacc = np.sum(tp) / max(np.sum(pos_gt), 1)
        res = {
            "mIoU": 100 * miou, "fwIoU": 100 * fiou,
            "mACC": 100 * macc, "pACC": 100 * pacc,
        }
        for i in range(n):
            res[f"IoU-{i}"] = 100 * iou[i]
            res[f"ACC-{i}"] = 100 * acc[i]
        if self._compute_boundary_iou:
            # per-class Boundary IoU (ref :344-356) + min(IoU, B-IoU) column
            b_iou = np.full(n, np.nan, dtype=np.float64)
            b_tp = self._b_conf_matrix.diagonal()[:-1].astype(np.float64)
            b_pos_gt = np.sum(
                self._b_conf_matrix[:-1, :-1], axis=0).astype(np.float64)
            b_pos_pred = np.sum(
                self._b_conf_matrix[:-1, :-1], axis=1).astype(np.float64)
            b_union = b_pos_gt + b_pos_pred - b_tp
            b_valid = b_union > 0
            b_iou[b_valid] = b_tp[b_valid] / b_union[b_valid]
            for i in range(n):
                res[f"BoundaryIoU-{i}"] = 100 * b_iou[i]
                res[f"min(IoU, B-Iou)-{i}"] = 100 * min(iou[i], b_iou[i])
        return res

    def evaluate(self) -> Optional[dict]:
        if self.mode == "supervised":
            return OrderedDict(sem_seg=self._metrics_from_conf())

        save_path = os.path.join(self.matching_dir, "semantic_mapping.json")
        if self.mode in ("hungarian_matching", "auto"):
            mapping = hungarian.semantic_majority_vote(
                np.asarray(self._pred_votes), np.asarray(self._gt_votes),
                num_labeled=self.num_pred_classes - 1,
                num_classes=NUM_SUPERCATEGORIES + 1,
            )
            hungarian.save_mapping(mapping, save_path)
            if self.mode == "hungarian_matching":
                logger.info("semantic mapping saved to %s", save_path)
                return {"semantic_mapping": save_path}
        else:
            mapping = hungarian.load_mapping(save_path)

        # eval pass: remap predictions, accumulate 16+1 confusion matrix.
        # Unmatched clusters go to the extra bin (ref :259-262 maps them to
        # _num_classes), NOT to the things slot 0.
        for pred, gt_super in self._pairs:
            remapped = np.zeros_like(pred)
            for p in np.unique(pred):
                m = mapping.get(int(p), -1)
                remapped[pred == p] = m if m != -1 else self._num_classes
            self._accumulate_conf(remapped, gt_super)
        return OrderedDict(sem_seg=self._metrics_from_conf())
