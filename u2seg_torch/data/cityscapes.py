"""Cityscapes dataset loading, instance and semantic (counterpart of
``u2seg_tpu/data/cityscapes.py``, after detectron2's
``data/datasets/cityscapes.py``): pairs leftImg8bit images with gtFine
annotation files; instance masks come from the *_instanceIds.png encoding
(id = class_id * 1000 + instance for things).
"""
from __future__ import annotations

import glob
import os
from typing import List, Tuple

import numpy as np

from u2seg_torch.data.catalog import DatasetCatalog, MetadataCatalog
from u2seg_torch.data.image_io import read_sem_seg
from u2seg_torch.evaluation import rle as rle_codec

# (name, train_id) of the 8 thing classes / 19 trainId classes
CITYSCAPES_THING_CLASSES = [
    "person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
]
CITYSCAPES_SEM_CLASSES = [
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
]
# labelId -> class index among things (from the cityscapes label table)
_THING_LABEL_IDS = {24: 0, 25: 1, 26: 2, 27: 3, 28: 4, 31: 5, 32: 6, 33: 7}


def _find_files(image_dir: str, gt_dir: str) -> List[Tuple[str, str, str]]:
    files = []
    for image_file in sorted(
        glob.glob(os.path.join(image_dir, "**", "*_leftImg8bit.png"),
                  recursive=True)
    ):
        suffix = "_leftImg8bit.png"
        prefix = os.path.relpath(image_file, image_dir)[: -len(suffix)]
        instance_file = os.path.join(gt_dir, prefix + "_gtFine_instanceIds.png")
        label_file = os.path.join(gt_dir, prefix + "_gtFine_labelIds.png")
        files.append((image_file, instance_file, label_file))
    return files


def _annotation(mask: np.ndarray, category_id: int, iscrowd: int) -> dict:
    """A region -> its dict: the tight box of its pixels, its area, its RLE."""
    ys, xs = np.nonzero(mask)
    x0, y0 = float(xs.min()), float(ys.min())
    return {
        "category_id": category_id,
        "bbox": [x0, y0, float(xs.max() + 1 - x0), float(ys.max() + 1 - y0)],
        "area": int(mask.sum()),
        "iscrowd": iscrowd,
        "segmentation": rle_codec.encode(mask.astype(np.uint8)),
    }


def load_cityscapes_instances(image_dir: str, gt_dir: str) -> List[dict]:
    """Instance segmentation dicts from the *_instanceIds.png files (read
    through Pillow, samples as stored): one RLE-masked annotation per thing
    instance (id = label_id * 1000 + k), and one ``iscrowd`` annotation per
    GROUP region of a thing class (id = label_id < 1000: a crowd of cars
    labeled jointly, an ignore region of the official protocol). A group's
    box is the tight box of its pixels, not the whole image: COCOeval's
    crowd IoU in the box path is intersection / detection area, so a
    whole-image crowd box would ignore every unmatched detection of the
    class instead of counting it as a false positive."""
    out = []
    for idx, (img_f, inst_f, _) in enumerate(_find_files(image_dir, gt_dir)):
        if not os.path.exists(inst_f):
            continue
        inst = read_sem_seg(inst_f)
        h, w = inst.shape
        anns = []
        for iid in np.unique(inst):
            if iid < 1000:
                if iid in _THING_LABEL_IDS:
                    anns.append(_annotation(inst == iid, _THING_LABEL_IDS[int(iid)], 1))
                continue
            label_id = iid // 1000
            if label_id in _THING_LABEL_IDS:
                anns.append(_annotation(inst == iid, _THING_LABEL_IDS[int(label_id)], 0))
        out.append({
            "file_name": img_f,
            "image_id": idx,
            "height": h,
            "width": w,
            "annotations": anns,
        })
    return out


def load_cityscapes_semantic(image_dir: str, gt_dir: str) -> List[dict]:
    out = []
    for idx, (img_f, _, label_f) in enumerate(_find_files(image_dir, gt_dir)):
        out.append({
            "file_name": img_f,
            "image_id": idx,
            "sem_seg_file_name": label_f,
        })
    return out


def register_cityscapes(root: str = "datasets/cityscapes"):
    for split in ("train", "val", "test"):
        image_dir = os.path.join(root, "leftImg8bit", split)
        gt_dir = os.path.join(root, "gtFine", split)
        inst_name = f"cityscapes_fine_instance_seg_{split}"
        if inst_name not in DatasetCatalog:
            DatasetCatalog.register(
                inst_name,
                lambda i=image_dir, g=gt_dir: load_cityscapes_instances(i, g),
            )
            MetadataCatalog.get(inst_name).set(
                thing_classes=CITYSCAPES_THING_CLASSES,
                evaluator_type="cityscapes_instance",
            )
        sem_name = f"cityscapes_fine_sem_seg_{split}"
        if sem_name not in DatasetCatalog:
            DatasetCatalog.register(
                sem_name,
                lambda i=image_dir, g=gt_dir: load_cityscapes_semantic(i, g),
            )
            MetadataCatalog.get(sem_name).set(
                stuff_classes=CITYSCAPES_SEM_CLASSES,
                evaluator_type="cityscapes_sem_seg",
                ignore_label=255,
            )
