"""COCO-format dataset loading and registration (counterpart of
``u2seg_tpu/data/coco.py``; detectron2's ``datasets/coco.py`` and
``coco_panoptic.py``).
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np

from u2seg_torch.data.catalog import DatasetCatalog, MetadataCatalog
from u2seg_torch.evaluation.coco_api import COCO

logger = logging.getLogger(__name__)


def load_coco_json(
    json_file: str,
    image_root: str,
    dataset_name: Optional[str] = None,
    extra_annotation_keys: Optional[List[str]] = None,
) -> List[dict]:
    """COCO instance json -> list of detectron2-style dataset dicts.

    Each dict: file_name, image_id, height, width, annotations=[
      {bbox (XYWH), category_id (contiguous), segmentation, iscrowd, area}].
    """
    coco_api = COCO(json_file)
    cat_ids = sorted(coco_api.getCatIds())
    cats = coco_api.loadCats(cat_ids)
    id_map = {v: i for i, v in enumerate(cat_ids)}
    if dataset_name is not None:
        meta = MetadataCatalog.get(dataset_name)
        meta.set(
            thing_classes=[c["name"] for c in sorted(cats, key=lambda x: x["id"])],
            thing_dataset_id_to_contiguous_id=id_map,
            json_file=json_file,
            image_root=image_root,
        )

    img_ids = sorted(coco_api.imgs.keys())
    imgs = coco_api.loadImgs(img_ids)
    anns = [coco_api.imgToAnns[img_id] for img_id in img_ids]
    extra = extra_annotation_keys or []

    dataset_dicts = []
    for img_dict, ann_list in zip(imgs, anns):
        record = {
            "file_name": os.path.join(image_root, img_dict["file_name"]),
            "height": img_dict["height"],
            "width": img_dict["width"],
            "image_id": img_dict["id"],
        }
        objs = []
        for ann in ann_list:
            assert ann["image_id"] == img_dict["id"]
            obj = {
                "bbox": ann["bbox"],
                "category_id": id_map[ann["category_id"]],
                "iscrowd": ann.get("iscrowd", 0),
                "area": ann.get("area", ann["bbox"][2] * ann["bbox"][3]),
            }
            if "segmentation" in ann:
                obj["segmentation"] = ann["segmentation"]
            for k in extra:
                if k in ann:
                    obj[k] = ann[k]
            objs.append(obj)
        record["annotations"] = objs
        dataset_dicts.append(record)
    return dataset_dicts


def load_sem_seg(gt_root: str, image_root: str, gt_ext: str = "png",
                 image_ext: str = "jpg") -> List[dict]:
    """Pair images with per-pixel gt files by basename (ref coco.py:230)."""
    def basename(p, ext):
        return os.path.basename(p)[: -len(ext) - 1]

    gt_files = sorted(
        os.path.join(gt_root, f) for f in os.listdir(gt_root)
        if f.endswith(gt_ext)
    )
    out = []
    for g in gt_files:
        base = basename(g, gt_ext)
        img = os.path.join(image_root, base + "." + image_ext)
        out.append({
            "file_name": img,
            "sem_seg_file_name": g,
        })
    return out


def register_coco_instances(name: str, metadata: dict, json_file: str,
                            image_root: str):
    DatasetCatalog.register(
        name, lambda: load_coco_json(json_file, image_root, name)
    )
    MetadataCatalog.get(name).set(
        json_file=json_file, image_root=image_root,
        evaluator_type="coco", **metadata,
    )


def merge_to_panoptic(detection_dicts: List[dict],
                      sem_seg_dicts: List[dict]) -> List[dict]:
    """Join instance dicts with sem-seg dicts on file_name
    (ref coco_panoptic.py:168)."""
    results = []
    by_file = {x["file_name"]: x for x in sem_seg_dicts}
    for det in detection_dicts:
        d = dict(det)
        ss = by_file.get(det["file_name"])
        if ss is not None:
            d["sem_seg_file_name"] = ss["sem_seg_file_name"]
        results.append(d)
    return results


def register_coco_panoptic_separated(
    name: str, metadata: dict, image_root: str, panoptic_root: str,
    panoptic_json: str, sem_seg_root: str, instances_json: str,
):
    """"separated" panoptic format: instance json for the detection branch +
    per-pixel semantic pngs for the sem-seg branch (ref coco_panoptic.py:102).
    """
    panoptic_name = name + "_separated"
    DatasetCatalog.register(
        panoptic_name,
        lambda: merge_to_panoptic(
            load_coco_json(instances_json, image_root, panoptic_name),
            load_sem_seg(sem_seg_root, image_root),
        ),
    )
    MetadataCatalog.get(panoptic_name).set(
        panoptic_root=panoptic_root,
        image_root=image_root,
        panoptic_json=panoptic_json,
        sem_seg_root=sem_seg_root,
        json_file=instances_json,
        evaluator_type="coco_panoptic_seg",
        ignore_label=255,
        **metadata,
    )

    # sem-seg-only view (ref coco_panoptic.py:137-155 registers
    # ``<name>_stuffonly`` alongside the separated dataset)
    stuff_name = name + "_stuffonly"
    DatasetCatalog.register(
        stuff_name, lambda: load_sem_seg(sem_seg_root, image_root)
    )
    MetadataCatalog.get(stuff_name).set(
        image_root=image_root,
        sem_seg_root=sem_seg_root,
        evaluator_type="sem_seg",
        ignore_label=255,
        **metadata,
    )
