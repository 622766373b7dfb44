"""LVIS dataset loading (counterpart of ``u2seg_tpu/data/lvis.py``, after
detectron2's ``data/datasets/lvis.py``), on the port's ``COCO`` index. The
LVIS json differs from COCO's: images carry ``not_exhaustive_category_ids``
and ``neg_category_ids``, and a file name may have to come from
``coco_url``.
"""
from __future__ import annotations

import os
from typing import List, Optional

from u2seg_torch.data.catalog import DatasetCatalog, MetadataCatalog
from u2seg_torch.evaluation.coco_api import COCO


def load_lvis_json(json_file: str, image_root: str,
                   dataset_name: Optional[str] = None) -> List[dict]:
    lvis = COCO(json_file)
    cat_ids = sorted(lvis.getCatIds())
    # LVIS v1 ids are already contiguous 1..C
    id_map = {v: i for i, v in enumerate(cat_ids)}
    if dataset_name is not None:
        cats = lvis.loadCats(cat_ids)
        MetadataCatalog.get(dataset_name).set(
            thing_classes=[
                c.get("synonyms", [c.get("name", str(c["id"]))])[0]
                for c in cats
            ],
            thing_dataset_id_to_contiguous_id=id_map,
        )
    out = []
    for img_id in sorted(lvis.imgs.keys()):
        img = lvis.imgs[img_id]
        if "file_name" in img:
            file_name = img["file_name"]
        else:
            # e.g. http://images.cocodataset.org/train2017/xxx.jpg
            coco_url = img["coco_url"]
            file_name = "/".join(coco_url.split("/")[-2:])
        record = {
            "file_name": os.path.join(image_root, file_name),
            "height": img["height"],
            "width": img["width"],
            "image_id": img_id,
            "not_exhaustive_category_ids": img.get(
                "not_exhaustive_category_ids", []
            ),
            "neg_category_ids": img.get("neg_category_ids", []),
        }
        objs = []
        for ann in lvis.imgToAnns[img_id]:
            objs.append({
                "bbox": ann["bbox"],
                "category_id": id_map[ann["category_id"]],
                "segmentation": ann.get("segmentation", []),
                "area": ann.get("area", ann["bbox"][2] * ann["bbox"][3]),
                "iscrowd": 0,
            })
        record["annotations"] = objs
        out.append(record)
    return out


def register_lvis_instances(name: str, metadata: dict, json_file: str,
                            image_root: str):
    DatasetCatalog.register(
        name, lambda: load_lvis_json(json_file, image_root, name)
    )
    MetadataCatalog.get(name).set(
        json_file=json_file, image_root=image_root,
        evaluator_type="lvis", **metadata,
    )
