"""Builtin dataset registration (counterpart of ``u2seg_tpu/data/builtin.py``).

Registration is an explicit call with the cluster count as an argument (no
import-time side effects, no environment variable). The COCO family is
registered eagerly; the keypoint and ADE20k sets register names and paths
only: nothing is read until a dataset is asked for.
"""
from __future__ import annotations

import os
from typing import Optional

from u2seg_torch.data.builtin_meta import cluster_metadata, coco_panoptic_metadata
from u2seg_torch.data.catalog import DatasetCatalog, MetadataCatalog
from u2seg_torch.data.coco import (
    register_coco_instances,
    register_coco_panoptic_separated,
)

_PREDEFINED_COCO = {
    "coco_2017_train": ("coco/train2017", "coco/annotations/instances_train2017.json"),
    "coco_2017_val": ("coco/val2017", "coco/annotations/instances_val2017.json"),
    "coco_2017_val_100": ("coco/val2017", "coco/annotations/instances_val2017_100.json"),
}

# U2Seg pseudo-label layout (ref builtin.py:67,100-116)
_U2SEG_TRAIN_JSON = "coco/annotations/cutler_curated/{n}_clusters/cluster_curated.json"
_U2SEG_PANOPTIC_ROOT = "coco/panoptic_anns/{n}_clusters/panoptic_ours"
_U2SEG_PANOPTIC_JSON = "coco/panoptic_anns/{n}_clusters/panoptic_coco.json"
_U2SEG_SEMSEG_ROOT = "coco/panoptic_anns/{n}_clusters/panoptic_stuff_ours"
_U2SEG_VAL_PANOPTIC_JSON = "coco/annotations/panoptic_val2017_{n}super.json"


def register_all_coco(
    root: str = "datasets",
    cluster_num: Optional[int] = None,
    supervised: bool = True,
):
    """Register COCO instance + panoptic-separated datasets.

    cluster_num: when given, ``coco_2017_train(_panoptic)`` point at the
    U2Seg pseudo-label artifacts with synthetic cluster metadata (the
    reference remaps the SAME names; we register distinct ``u2seg_*`` names
    and alias the coco names when supervised=False).
    """
    if supervised:
        meta = coco_panoptic_metadata()
        for name, (image_dir, json_file) in _PREDEFINED_COCO.items():
            if name in DatasetCatalog:
                continue
            register_coco_instances(
                name,
                {k: meta[k] for k in
                 ("thing_classes", "thing_dataset_id_to_contiguous_id")},
                os.path.join(root, json_file),
                os.path.join(root, image_dir),
            )
        for split in ("train", "val"):
            pan_name = f"coco_2017_{split}_panoptic"
            if pan_name + "_separated" not in DatasetCatalog:
                register_coco_panoptic_separated(
                    pan_name,
                    meta,
                    os.path.join(root, f"coco/{split}2017"),
                    os.path.join(root, f"coco/panoptic_{split}2017"),
                    os.path.join(
                        root, f"coco/annotations/panoptic_{split}2017.json"),
                    os.path.join(root, f"coco/panoptic_stuff_{split}2017"),
                    os.path.join(
                        root, f"coco/annotations/instances_{split}2017.json"),
                )
        register_all_coco_keypoints(root)

    if cluster_num:  # None or 0 -> supervised COCO only
        meta = cluster_metadata(cluster_num)
        n = cluster_num
        train_name = f"u2seg_{n}_train_panoptic"
        if train_name + "_separated" not in DatasetCatalog:
            register_coco_panoptic_separated(
                train_name,
                meta,
                os.path.join(root, "coco/train2017"),
                os.path.join(root, _U2SEG_PANOPTIC_ROOT.format(n=n)),
                os.path.join(root, _U2SEG_PANOPTIC_JSON.format(n=n)),
                os.path.join(root, _U2SEG_SEMSEG_ROOT.format(n=n)),
                os.path.join(root, _U2SEG_TRAIN_JSON.format(n=n)),
            )
        val_name = f"u2seg_{n}_val_panoptic"
        if val_name + "_separated" not in DatasetCatalog:
            register_coco_panoptic_separated(
                val_name,
                meta,
                os.path.join(root, "coco/val2017"),
                os.path.join(root, "coco/panoptic_val2017"),
                os.path.join(root, _U2SEG_VAL_PANOPTIC_JSON.format(n=n)),
                os.path.join(root, "coco/panoptic_stuff_val2017"),
                os.path.join(root, "coco/annotations/instances_val2017.json"),
            )


_PREDEFINED_COCO_KEYPOINTS = {
    "keypoints_coco_2017_train": (
        "coco/train2017", "coco/annotations/person_keypoints_train2017.json"),
    "keypoints_coco_2017_val": (
        "coco/val2017", "coco/annotations/person_keypoints_val2017.json"),
    "keypoints_coco_2017_val_100": (
        "coco/val2017",
        "coco/annotations/person_keypoints_val2017_100.json"),
}


def register_all_coco_keypoints(root: str = "datasets"):
    """COCO person-keypoint datasets (ref builtin.py
    _PREDEFINED_SPLITS_COCO["coco_person"] + _get_coco_instances_meta
    keypoint fields): single "person" thing class plus keypoint names and
    the left/right flip map used by RandomFlip."""
    from u2seg_torch.data.builtin_meta import (
        COCO_PERSON_KEYPOINT_FLIP_MAP, COCO_PERSON_KEYPOINT_NAMES,
    )

    meta = {
        "thing_classes": ["person"],
        "thing_dataset_id_to_contiguous_id": {1: 0},
        "keypoint_names": list(COCO_PERSON_KEYPOINT_NAMES),
        "keypoint_flip_map": list(COCO_PERSON_KEYPOINT_FLIP_MAP),
    }
    for name, (image_dir, json_file) in _PREDEFINED_COCO_KEYPOINTS.items():
        if name in DatasetCatalog:
            continue
        register_coco_instances(
            name, meta,
            os.path.join(root, json_file),
            os.path.join(root, image_dir),
        )


def register_ade20k(root: str = "datasets"):
    """ADE20k-150 semantic segmentation (ref builtin.py register_all_ade20k:
    images + per-pixel annotation pngs prepared by prepare_ade20k_sem_seg)."""
    from u2seg_torch.data.coco import load_sem_seg

    for split in ("training", "validation"):
        name = f"ade20k_sem_seg_{split[:5]}" if split == "training" else \
            "ade20k_sem_seg_val"
        name = "ade20k_sem_seg_train" if split == "training" else name
        if name in DatasetCatalog:
            continue
        image_dir = os.path.join(root, "ADEChallengeData2016/images", split)
        gt_dir = os.path.join(
            root, "ADEChallengeData2016/annotations_detectron2", split
        )
        DatasetCatalog.register(
            name, lambda i=image_dir, g=gt_dir: load_sem_seg(g, i)
        )
        MetadataCatalog.get(name).set(
            evaluator_type="sem_seg", ignore_label=255,
            image_root=image_dir, sem_seg_root=gt_dir,
        )
