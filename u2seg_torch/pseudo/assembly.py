"""Pseudo-annotation assembly: cluster-labelled instances + STEGO semantics
-> COCO-panoptic training annotations (a numpy copy of
``u2seg_tpu/pseudo/assembly.py``).

Counterpart of ``datasets/prepare_ours/`` in the reference:
  - ``generate_classaware_instanceseg_annotations.py`` (cluster ids onto
    class-agnostic CutLER masks, :52)
  - ``generate_pseudo_panoptic.py`` (area-desc instance paste :102-110,
    drop fully-overwritten :112-119, STEGO stuff fill with >0.7-overlap
    skip :123-143, id2rgb PNGs :147-153)
  - ``get_panoptic_anns_supercategory.py`` (GT val stuff 53 -> 15
    supercategories at ids cluster_num+1..+15)
  - ``prepare_stuff_panoptic_fpn.py`` (panoptic PNG -> semantic PNG:
    things->0, stuff->contiguous, ignore->255)

The PNG helpers are the port's ``data/image_io.py`` (Pillow, imported
inside the call).
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from u2seg_torch.data.builtin_meta import STUFF_TO_SUPERCATEGORY, create_cate
from u2seg_torch.data.image_io import (  # noqa: F401  (the module's PNG helpers)
    id2rgb, read_panoptic_png, rgb2id, write_panoptic_png,
)
from u2seg_torch.evaluation import rle as rle_codec


def assign_cluster_ids(class_agnostic_json: dict, cluster_decode: Dict[str, int],
                       cluster_num: int) -> dict:
    """Class-agnostic instance json + {instance key: cluster id} -> class-aware
    instance json (category_id = cluster id + 1, categories 1..N+27). Keys
    are "{image_id}_{ann_id}" (generate_classaware... :52); an annotation
    without one is dropped."""
    out = copy.deepcopy(class_agnostic_json)
    out["categories"] = create_cate(cluster_num)
    kept = []
    for ann in out.get("annotations", []):
        key = f"{ann['image_id']}_{ann['id']}"
        if key not in cluster_decode:
            continue
        ann["category_id"] = int(cluster_decode[key]) + 1
        kept.append(ann)
    out["annotations"] = kept
    return out


def merge_instances_and_stego(instances: Sequence[dict], stego_map: np.ndarray,
                              cluster_num: int, hw: Tuple[int, int],
                              overlap_skip: float = 0.7) -> Tuple[np.ndarray, List[dict]]:
    """One image's pseudo panoptic map + segments_info, as
    generate_pseudo_panoptic.py makes them:
      - instance masks pasted in DESCENDING area order (small instances
        overwrite big ones, :102-110);
      - instances whose pixels were all overwritten dropped (:112-119);
      - each STEGO label a stuff segment of category cluster_num + 1 +
        label, unless instances cover > ``overlap_skip`` of it (:123-143).
    Every segmentation is decoded as RLE (CutLER's format; a polygon raises,
    as in the JAX package). The JAX function's ``decode_fn``, which no
    caller sets, is left out."""
    h, w = hw
    pan = np.zeros((h, w), np.int64)
    next_id = 1
    segs: List[dict] = []

    ids = []
    for ann in sorted(instances, key=lambda a: -a.get("area", 0)):
        sid = next_id
        next_id += 1
        pan[rle_codec.decode(ann["segmentation"]).astype(bool)] = sid
        ids.append((sid, ann))
    remaining = set(np.unique(pan).tolist())
    for sid, ann in ids:
        if sid not in remaining:
            continue
        segs.append({"id": sid, "category_id": int(ann["category_id"]), "isthing": 1,
                     "area": int(np.sum(pan == sid)), "iscrowd": 0})

    claimed = pan > 0
    stego = np.asarray(stego_map)
    for label in np.unique(stego):
        region = stego == label
        total = int(region.sum())
        if total == 0:
            continue
        if int((region & claimed).sum()) / total > overlap_skip:
            continue
        free = region & ~claimed
        if not free.any():
            continue
        sid = next_id
        next_id += 1
        pan[free] = sid
        segs.append({"id": sid, "category_id": int(cluster_num + 1 + label), "isthing": 0,
                     "area": int(free.sum()), "iscrowd": 0})
    return pan, segs


def panoptic_to_semantic(pan: np.ndarray, segments: Sequence[dict],
                         stuff_base: Optional[int] = None) -> np.ndarray:
    """Panoptic id map -> semantic training map for PanopticFPN: things 0,
    stuff category c -> c - stuff_base (or its rank among the image's stuff
    categories + 1 when stuff_base is None), unlabelled 255
    (prepare_stuff_panoptic_fpn.py:30-70). The JAX function's
    ``thing_to_zero``, which it never reads, is left out."""
    out = np.full(pan.shape, 255, np.uint8)
    stuff_cats = sorted({
        s["category_id"] for s in segments if not s.get("isthing", 1)
    }) if stuff_base is None else None
    for s in segments:
        mask = pan == s["id"]
        if s.get("isthing", 1):
            out[mask] = 0
        elif stuff_base is not None:
            out[mask] = s["category_id"] - stuff_base
        else:
            out[mask] = stuff_cats.index(s["category_id"]) + 1
    return out


def gt_panoptic_to_supercategories(panoptic_json: dict, cluster_num: int) -> dict:
    """GT COCO panoptic json: the 53 stuff categories -> 15 supercategories
    at ids cluster_num+1..+15; things unchanged
    (get_panoptic_anns_supercategory.py:8-27). Makes the
    ``panoptic_val2017_{N}super.json`` evaluation GT."""
    out = copy.deepcopy(panoptic_json)
    for ann in out.get("annotations", []):
        for seg in ann.get("segments_info", []):
            cid = seg["category_id"]
            if cid in STUFF_TO_SUPERCATEGORY:
                seg["category_id"] = cluster_num + STUFF_TO_SUPERCATEGORY[cid]
    new_cats, seen = [], set()
    for cat in out.get("categories", []):
        cid = cat["id"]
        if cid in STUFF_TO_SUPERCATEGORY:
            sup = cluster_num + STUFF_TO_SUPERCATEGORY[cid]
            if sup not in seen:
                seen.add(sup)
                new_cats.append({
                    "id": sup, "name": f"super_{STUFF_TO_SUPERCATEGORY[cid]}",
                    "isthing": 0, "supercategory": cat.get("supercategory", ""),
                })
        else:
            new_cats.append(cat)
    out["categories"] = new_cats
    return out
