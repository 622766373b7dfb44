"""U2Seg's cluster -> category matching protocol, "Hungarian matching" in
the code base although it is a majority vote (counterpart of
``u2seg_tpu/evaluation/hungarian.py``):
  - instances: predictions with score > 0.6 whose box IoU with a GT box
    exceeds 0.7 vote for that GT's class; each cluster maps to the majority
    class (-1 if no votes);
  - semantics: predicted stuff cluster masks vote for GT supercategories
    when their mask IoU exceeds 0.15.

Pass 1 writes ``{instance,semantic}_mapping.json`` into the matching
directory, pass 2 reads them; ``auto`` does both in one run.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def majority_vote_mapping(
    pred_clusters: np.ndarray,
    gt_classes: np.ndarray,
    num_clusters: int,
    num_classes: int,
) -> Dict[int, int]:
    """Cluster id -> majority gt class; -1 for clusters with no votes
    (ref coco_evaluation.py:274-294 ``hungarain_matching``)."""
    mapping: Dict[int, int] = {}
    pred_clusters = np.asarray(pred_clusters)
    gt_classes = np.asarray(gt_classes)
    for i in range(num_clusters):
        votes = gt_classes[pred_clusters == i]
        if votes.size == 0:
            mapping[i] = -1
        else:
            mapping[i] = int(np.argmax(np.bincount(votes, minlength=num_classes)))
    return mapping


def mine_instance_pairs(
    results: Sequence[dict],
    gt_by_image: Dict[int, List[dict]],
    gt_id_to_contiguous: Dict[int, int],
    score_thresh: float = 0.6,
    iou_thresh: float = 0.7,
) -> Tuple[np.ndarray, np.ndarray]:
    """(pred_cluster, gt_class) vote pairs from box matches.

    results: COCO-format detection dicts (bbox XYWH, category_id = cluster).
    gt_by_image: image_id -> list of GT anns (bbox XYWH, category_id).
    """
    pred_cl: List[int] = []
    gt_cl: List[int] = []
    for r in results:
        if r["score"] < score_thresh:
            continue
        anns = gt_by_image.get(r["image_id"], [])
        if not anns:
            continue
        px, py, pw, ph = r["bbox"]
        pa = pw * ph
        for ann in anns:
            gx, gy, gw, gh = ann["bbox"]
            iw = min(px + pw, gx + gw) - max(px, gx)
            ih = min(py + ph, gy + gh) - max(py, gy)
            if iw <= 0 or ih <= 0:
                continue
            inter = iw * ih
            union = pa + gw * gh - inter
            if union > 0 and inter / union > iou_thresh:
                gt_cl.append(gt_id_to_contiguous[ann["category_id"]])
                pred_cl.append(r["category_id"])
    return np.asarray(pred_cl, np.int64), np.asarray(gt_cl, np.int64)


def mine_semantic_pairs(
    pred: np.ndarray,
    gt_super: np.ndarray,
    iou_thresh: float = 0.15,
    gt_ignore: Tuple[int, ...] = (0, 16),
) -> Tuple[List[int], List[int]]:
    """Per-image (pred_cluster, gt_supercategory) vote pairs from mask IoU
    (ref sem_seg_evaluation.py:203-227 — note the reference's IoU denominator
    is the *union as boolean sum* np.sum(mask_pred + mask_gt), reproduced
    here; pred label 0 and gt labels {0, 16} skipped)."""
    preds: List[int] = []
    gts: List[int] = []
    for p in np.unique(pred):
        if p == 0:
            continue
        mask_p = pred == p
        for g in np.unique(gt_super):
            if g in gt_ignore or g == 255:
                continue
            mask_g = gt_super == g
            union = np.sum(mask_p | mask_g)
            if union == 0:
                continue
            iou = np.sum(mask_p & mask_g) / union
            if iou > iou_thresh:
                gts.append(int(g))
                preds.append(int(p))
    return preds, gts


def semantic_majority_vote(
    all_preds: np.ndarray, all_targets: np.ndarray,
    num_labeled: int, num_classes: int,
) -> Dict[int, int]:
    """Semantic variant: clusters are 1-based, cluster 0 maps to 0
    (ref sem_seg_evaluation.py:146-159)."""
    mapping: Dict[int, int] = {}
    all_preds = np.asarray(all_preds)
    all_targets = np.asarray(all_targets)
    for i in range(1, num_labeled + 1):
        votes = all_targets[all_preds == i]
        if votes.size == 0:
            mapping[i] = -1
        else:
            mapping[i] = int(np.argmax(np.bincount(votes, minlength=num_classes)))
    mapping[0] = 0
    return mapping


# ---------------------------------------------------------------------------
# artifact IO (compat with the reference's two-pass scheme)
# ---------------------------------------------------------------------------

def save_mapping(mapping: Dict[int, int], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({str(k): v for k, v in mapping.items()}, f, ensure_ascii=False)


def load_mapping(path: str) -> Dict[int, int]:
    with open(path) as f:
        raw = json.load(f)
    return {int(k): int(v) for k, v in raw.items()}


def remap_instance_results(
    results: Sequence[dict],
    mapping: Dict[int, int],
    contiguous_to_dataset_id: Dict[int, int],
) -> List[dict]:
    """Apply the instance mapping: drop unmatched clusters, rewrite
    category_id to real dataset ids (ref coco_evaluation.py:316-332)."""
    out = []
    for r in results:
        matched = mapping.get(r["category_id"], -1)
        if matched == -1:
            continue
        r = dict(r)
        r["category_id"] = contiguous_to_dataset_id[matched]
        out.append(r)
    return out
