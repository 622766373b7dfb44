"""Cityscapes official-protocol instance-level AP (counterpart of
``u2seg_tpu/evaluation/cityscapes_instance_ap.py``).

Re-derivation of cityscapesscripts'
``evaluation/evalInstanceLevelSemanticLabeling.py`` (the script the
reference shells out to from
``detectron2/evaluation/cityscapes_evaluation.py:197``), which differs
from COCO AP in several load-bearing ways:

  - matching is confidence-weighted per GT: when several predictions
    overlap one GT above the threshold, the GT keeps the HIGHEST
    confidence and every other match is demoted to a false positive
    carrying the LOWER confidence;
  - GT instances smaller than ``min_region_size`` px are excluded, and
    unmatched predictions whose pixels fall mostly (> overlap threshold)
    into ignore regions (group/crowd regions, undersized GT, explicit
    void) are NOT false positives;
  - unmatched GT instances enter the recall denominator as "hard" false
    negatives rather than as curve points;
  - the PR curve is integrated with centered step widths
    (convolve(recall, [-0.5, 0, 0.5])) instead of COCO's 101-point
    interpolation;
  - AP averages the 10 overlaps 0.50:0.05:0.95; AP50 is the 0.5 column.

cityscapesscripts is not a dependency, so the distinctive behaviors are
pinned by hand-built cases (``tests/test_torch_zoo_datasets.py``, after the
JAX package's ``tests/evaluation/test_cityscapes_official.py``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

OVERLAPS = np.arange(0.5, 1.0, 0.05)
MIN_REGION_SIZE = 100  # official minRegionSizes[0] for the "all" setting


def _ap_from_curve(y_true: np.ndarray, y_score: np.ndarray,
                   hard_fns: int) -> float:
    """Official PR-curve construction + centered-step integration
    (evalInstanceLevelSemanticLabeling.py evaluateMatches tail)."""
    order = np.argsort(y_score, kind="mergesort")
    y_score = y_score[order]
    y_true = y_true[order]
    cum_true = np.cumsum(y_true)
    thresholds, unique_idx = np.unique(y_score, return_index=True)
    n = len(y_score)
    n_true = cum_true[-1] if n else 0

    precision = np.zeros(len(thresholds) + 1)
    recall = np.zeros(len(thresholds) + 1)
    for i, idx in enumerate(unique_idx):
        below = cum_true[idx - 1] if idx > 0 else 0
        tp = n_true - below
        fp = n - idx - tp
        fn = below + hard_fns
        precision[i] = tp / max(tp + fp, 1e-12)
        recall[i] = tp / max(tp + fn, 1e-12)
    precision[-1] = 1.0
    recall[-1] = 0.0

    # centered step widths: sw[i] = (recall[i-1] - recall[i+1]) / 2 with
    # replicated/zero edge padding (np.convolve reverses the kernel)
    recall_c = np.concatenate([[recall[0]], recall, [0.0]])
    step_widths = np.convolve(recall_c, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, step_widths))


def evaluate_instance_ap(
    gt_by_image: Dict,        # image_id -> list of gt dicts
    pred_by_image: Dict,      # image_id -> list of pred dicts
    num_classes: int,
    overlaps: Sequence[float] = tuple(OVERLAPS),
    min_region_size: int = MIN_REGION_SIZE,
) -> dict:
    """Official cityscapes instance AP.

    gt dicts:  {"mask": (H, W) bool, "class": int, "ignore": bool}
               (ignore = crowd/group region of the class)
    pred dicts: {"mask": (H, W) bool, "class": int, "score": float}
    Optionally each image's gt list may include entries with class == -1:
    explicit void regions (ignore for every class).

    Returns {"AP", "AP50", "per_class": (C,) array (nan = no GT)}.
    """
    overlaps = np.asarray(list(overlaps))
    image_ids = sorted(set(gt_by_image) | set(pred_by_image))

    # precompute per-image, per-class matching tables
    # tables[img][cls] = dict(gts=[(pixel_count)], preds=[(score, count)],
    #                         inter (G, P), ignore_inter (P,))
    tables = {}
    gt_counts = np.zeros(num_classes, np.int64)
    for img in image_ids:
        gts_all = gt_by_image.get(img, [])
        preds_all = pred_by_image.get(img, [])
        void_masks = [g["mask"] for g in gts_all if g.get("class", 0) == -1]
        per_cls = {}
        for cls in range(num_classes):
            gts = [g for g in gts_all
                   if g["class"] == cls and not g.get("ignore", False)]
            # undersized GT joins the ignore pool (official: excluded from
            # matching, counted toward a pred's ignore proportion)
            kept = [g for g in gts if int(g["mask"].sum()) >= min_region_size]
            small = [g for g in gts if int(g["mask"].sum()) < min_region_size]
            ignore_masks = (
                [g["mask"] for g in gts_all
                 if g["class"] == cls and g.get("ignore", False)]
                + [g["mask"] for g in small] + void_masks
            )
            preds = [p for p in preds_all if p["class"] == cls]
            g_n, p_n = len(kept), len(preds)
            inter = np.zeros((g_n, p_n), np.int64)
            ig_inter = np.zeros(p_n, np.int64)
            p_count = np.zeros(p_n, np.int64)
            for pi, p in enumerate(preds):
                pm = p["mask"]
                p_count[pi] = int(pm.sum())
                for gi, g in enumerate(kept):
                    inter[gi, pi] = int(np.logical_and(g["mask"], pm).sum())
                # official protocol SUMS per-region intersections
                # (voidIntersection + each ignored instance separately,
                # cityscapesscripts evalInstanceLevelSemanticLabeling):
                # overlapping ignore regions count multiply, so a union
                # here would under-count the ignore proportion
                ig_inter[pi] = sum(
                    int(np.logical_and(m, pm).sum()) for m in ignore_masks
                )
            per_cls[cls] = {
                "g_count": np.array([int(g["mask"].sum()) for g in kept],
                                    np.int64),
                "p_count": p_count,
                "p_score": np.array([float(p["score"]) for p in preds]),
                "inter": inter,
                "ig_inter": ig_inter,
            }
            gt_counts[cls] += g_n
        tables[img] = per_cls

    per_class_ap = np.full((num_classes, len(overlaps)), np.nan)
    for cls in range(num_classes):
        if gt_counts[cls] == 0:
            continue  # nan: class not annotated in this split
        for oi, th in enumerate(overlaps):
            y_true: List[float] = []
            y_score: List[float] = []
            hard_fns = 0
            for img in image_ids:
                t = tables[img][cls]
                g_n = len(t["g_count"])
                p_n = len(t["p_count"])
                union = (t["g_count"][:, None] + t["p_count"][None, :]
                         - t["inter"])
                ov = t["inter"] / np.maximum(union, 1)
                cur_match = np.zeros(g_n, bool)
                cur_score = np.full(g_n, -np.inf)
                extra_true: List[float] = []
                extra_score: List[float] = []
                for gi in range(g_n):
                    found = False
                    for pi in range(p_n):
                        if ov[gi, pi] <= th:
                            continue
                        conf = t["p_score"][pi]
                        if cur_match[gi]:
                            # duplicate: higher confidence keeps the GT,
                            # the other becomes an FP at the LOWER score
                            hi = max(cur_score[gi], conf)
                            lo = min(cur_score[gi], conf)
                            cur_score[gi] = hi
                            extra_true.append(0.0)
                            extra_score.append(lo)
                        else:
                            found = True
                            cur_match[gi] = True
                            cur_score[gi] = conf
                    if not found:
                        hard_fns += 1
                y_true.extend([1.0] * int(cur_match.sum()))
                y_score.extend(cur_score[cur_match].tolist())
                y_true.extend(extra_true)
                y_score.extend(extra_score)
                # unmatched predictions -> FP unless mostly ignore
                for pi in range(p_n):
                    if g_n and (ov[:, pi] > th).any():
                        continue
                    prop = t["ig_inter"][pi] / max(t["p_count"][pi], 1)
                    if prop <= th:
                        y_true.append(0.0)
                        y_score.append(float(t["p_score"][pi]))
            if not y_true:
                per_class_ap[cls, oi] = 0.0
                continue
            per_class_ap[cls, oi] = _ap_from_curve(
                np.asarray(y_true), np.asarray(y_score), hard_fns
            )

    ap_per_class = np.array([
        np.nan if np.isnan(row).all() else np.nanmean(row)
        for row in per_class_ap
    ])
    ap50_per_class = per_class_ap[:, 0]
    valid = ~np.isnan(ap_per_class)
    return {
        "AP": float(np.mean(ap_per_class[valid])) if valid.any() else float("nan"),
        "AP50": float(np.mean(ap50_per_class[valid])) if valid.any() else float("nan"),
        "per_class": ap_per_class,
    }
