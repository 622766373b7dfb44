"""Panoptic Quality (PQ), panopticapi's ``pq_compute`` in numpy (counterpart
of ``u2seg_tpu/evaluation/panoptic_eval_core.py``):

  - segments match iff IoU > 0.5 (unique by pigeonhole);
  - VOID (label 0) gt pixels are excluded from the union;
  - crowd gt segments don't participate in matching, but unmatched
    predictions overlapped > 0.5 by (VOID + same-class crowd) are excused
    from the FP count;
  - PQ = sum(IoU of TPs) / (TP + FP/2 + FN/2), per category, averaged over
    categories that appear.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

VOID = 0
OFFSET = 256 ** 3


class PQStatCat:
    __slots__ = ("iou", "tp", "fp", "fn")

    def __init__(self):
        self.iou = 0.0
        self.tp = 0
        self.fp = 0
        self.fn = 0

    def __iadd__(self, other):
        self.iou += other.iou
        self.tp += other.tp
        self.fp += other.fp
        self.fn += other.fn
        return self


class PQStat:
    def __init__(self):
        self.per_cat: Dict[int, PQStatCat] = defaultdict(PQStatCat)

    def __getitem__(self, cat_id: int) -> PQStatCat:
        return self.per_cat[cat_id]

    def __iadd__(self, other: "PQStat"):
        for cat, stat in other.per_cat.items():
            self.per_cat[cat] += stat
        return self

    def pq_average(self, categories: Dict[int, dict], isthing: Optional[bool] = None):
        pq, sq, rq, n = 0.0, 0.0, 0.0, 0
        per_class = {}
        for cat_id, cat in categories.items():
            if isthing is not None and bool(cat["isthing"]) != isthing:
                continue
            s = self.per_cat[cat_id]
            if s.tp + s.fp + s.fn == 0:
                per_class[cat_id] = {"pq": 0.0, "sq": 0.0, "rq": 0.0}
                continue
            n += 1
            pq_c = s.iou / (s.tp + 0.5 * s.fp + 0.5 * s.fn)
            sq_c = s.iou / s.tp if s.tp != 0 else 0.0
            rq_c = s.tp / (s.tp + 0.5 * s.fp + 0.5 * s.fn)
            per_class[cat_id] = {"pq": pq_c, "sq": sq_c, "rq": rq_c}
            pq += pq_c
            sq += sq_c
            rq += rq_c
        if n == 0:
            return {"pq": 0.0, "sq": 0.0, "rq": 0.0, "n": 0}, per_class
        return {"pq": pq / n, "sq": sq / n, "rq": rq / n, "n": n}, per_class


def pq_compute_single_image(
    pan_gt: np.ndarray,
    pan_pred: np.ndarray,
    gt_segments: Sequence[dict],
    pred_segments: Sequence[dict],
    categories: Dict[int, dict],
) -> PQStat:
    """One image's PQ statistics.

    pan_gt / pan_pred: (H, W) int arrays of segment ids (0 = VOID/unlabeled).
    *_segments: list of {"id", "category_id", ...}, gt may carry "iscrowd".
    """
    pq_stat = PQStat()
    gt_by_id = {s["id"]: s for s in gt_segments}
    pred_by_id = {s["id"]: s for s in pred_segments}

    # areas (panopticapi recomputes pred areas from the png; do the same)
    gt_ids, gt_counts = np.unique(pan_gt, return_counts=True)
    pred_ids, pred_counts = np.unique(pan_pred, return_counts=True)
    gt_areas = dict(zip(gt_ids.tolist(), gt_counts.tolist()))
    pred_areas = dict(zip(pred_ids.tolist(), pred_counts.tolist()))

    # sanity: predictions must cover only known segment ids
    for pid in pred_ids.tolist():
        if pid != VOID and pid not in pred_by_id:
            raise KeyError(
                f"segment id {pid} in predicted panoptic map has no "
                "segments_info entry"
            )

    # intersections via combined map
    combined = pan_gt.astype(np.uint64) * OFFSET + pan_pred.astype(np.uint64)
    comb_ids, comb_counts = np.unique(combined, return_counts=True)
    inter: Dict[Tuple[int, int], int] = {}
    for cid, cnt in zip(comb_ids.tolist(), comb_counts.tolist()):
        inter[(int(cid // OFFSET), int(cid % OFFSET))] = int(cnt)

    matched_gt, matched_pred = set(), set()
    for (gid, pid), i in inter.items():
        if gid not in gt_by_id or pid not in pred_by_id:
            continue
        gseg, pseg = gt_by_id[gid], pred_by_id[pid]
        if gseg.get("iscrowd", 0) == 1:
            continue
        if gseg["category_id"] != pseg["category_id"]:
            continue
        union = (
            gt_areas.get(gid, 0) + pred_areas.get(pid, 0) - i
            - inter.get((VOID, pid), 0)
        )
        iou = i / union if union > 0 else 0.0
        if iou > 0.5:
            cat = gseg["category_id"]
            pq_stat[cat].tp += 1
            pq_stat[cat].iou += iou
            matched_gt.add(gid)
            matched_pred.add(pid)

    # FN: unmatched non-crowd gt
    crowd_area_by_cat: Dict[int, int] = {}
    for gid, gseg in gt_by_id.items():
        if gseg.get("iscrowd", 0) == 1:
            crowd_area_by_cat[gseg["category_id"]] = gid
            continue
        if gid not in matched_gt:
            pq_stat[gseg["category_id"]].fn += 1

    # FP: unmatched pred not excused by VOID + same-class crowd
    for pid, pseg in pred_by_id.items():
        if pid in matched_pred:
            continue
        parea = pred_areas.get(pid, 0)
        if parea == 0:
            continue
        excuse = inter.get((VOID, pid), 0)
        crowd_gid = crowd_area_by_cat.get(pseg["category_id"])
        if crowd_gid is not None:
            excuse += inter.get((crowd_gid, pid), 0)
        if excuse / parea > 0.5:
            continue
        pq_stat[pseg["category_id"]].fp += 1
    return pq_stat


def pq_compute(
    gt_images: Sequence[Tuple[np.ndarray, Sequence[dict]]],
    pred_images: Sequence[Tuple[np.ndarray, Sequence[dict]]],
    categories: Dict[int, dict],
) -> Dict[str, dict]:
    """Aggregate PQ over a dataset.

    Returns the panopticapi-style result dict with "All"/"Things"/"Stuff"
    averages and per-class numbers.
    """
    total = PQStat()
    for (pan_gt, gt_segs), (pan_pred, pred_segs) in zip(gt_images, pred_images):
        total += pq_compute_single_image(
            pan_gt, pan_pred, gt_segs, pred_segs, categories
        )
    results = {}
    for name, isthing in [("All", None), ("Things", True), ("Stuff", False)]:
        avg, per_class = total.pq_average(categories, isthing)
        results[name] = avg
        if name == "All":
            results["per_class"] = per_class
    return results
