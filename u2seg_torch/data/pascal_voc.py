"""Pascal VOC dataset loading (counterpart of ``u2seg_tpu/data/pascal_voc.py``,
after detectron2's ``data/datasets/pascal_voc.py``): VOC XML annotations
parsed into dataset dicts, boxes moved from VOC's 1-based inclusive corners to
0-based XYWH.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Tuple

from u2seg_torch.data.catalog import DatasetCatalog, MetadataCatalog

VOC_CLASS_NAMES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def load_voc_instances(dirname: str, split: str,
                       class_names: Tuple[str, ...] = VOC_CLASS_NAMES) -> List[dict]:
    with open(os.path.join(dirname, "ImageSets", "Main", split + ".txt")) as f:
        fileids = [line.strip() for line in f if line.strip()]

    dicts = []
    for fileid in fileids:
        anno_file = os.path.join(dirname, "Annotations", fileid + ".xml")
        jpeg_file = os.path.join(dirname, "JPEGImages", fileid + ".jpg")
        tree = ET.parse(anno_file)
        r = {
            "file_name": jpeg_file,
            "image_id": fileid,
            "height": int(tree.findall("./size/height")[0].text),
            "width": int(tree.findall("./size/width")[0].text),
        }
        instances = []
        for obj in tree.findall("object"):
            cls = obj.find("name").text
            if cls not in class_names:
                continue
            difficult = int(obj.find("difficult").text) if obj.find(
                "difficult"
            ) is not None else 0
            bbox = obj.find("bndbox")
            # VOC is 1-indexed inclusive; convert to XYWH 0-indexed
            x0 = float(bbox.find("xmin").text) - 1.0
            y0 = float(bbox.find("ymin").text) - 1.0
            x1 = float(bbox.find("xmax").text)
            y1 = float(bbox.find("ymax").text)
            instances.append({
                "category_id": class_names.index(cls),
                "bbox": [x0, y0, x1 - x0, y1 - y0],
                "area": (x1 - x0) * (y1 - y0),
                "iscrowd": 0,
                "difficult": difficult,
            })
        r["annotations"] = instances
        dicts.append(r)
    return dicts


def register_pascal_voc(name: str, dirname: str, split: str, year: int,
                        class_names=VOC_CLASS_NAMES):
    DatasetCatalog.register(
        name, lambda: load_voc_instances(dirname, split, class_names)
    )
    MetadataCatalog.get(name).set(
        thing_classes=list(class_names), dirname=dirname, year=year,
        split=split, evaluator_type="pascal_voc",
    )
