"""Lightweight COCO annotation index, pycocotools' ``COCO`` surface that the
loaders and evaluators use (counterpart of ``u2seg_tpu/evaluation/coco_api.py``):
getAnnIds/getCatIds/getImgIds, loadAnns/loadCats/loadImgs, loadRes,
annToRLE/annToMask.
"""
from __future__ import annotations

import copy
import json
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from u2seg_torch.evaluation import rle as rle_codec


class COCO:
    def __init__(self, annotation_file: Optional[Union[str, dict]] = None):
        self.dataset: dict = {}
        self.anns: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.imgToAnns: Dict[int, List[dict]] = defaultdict(list)
        self.catToImgs: Dict[int, List[int]] = defaultdict(list)
        if annotation_file is not None:
            if isinstance(annotation_file, str):
                with open(annotation_file) as f:
                    dataset = json.load(f)
            else:
                dataset = annotation_file
            assert isinstance(dataset, dict)
            self.dataset = dataset
            self.createIndex()

    def createIndex(self):
        anns, cats, imgs = {}, {}, {}
        imgToAnns, catToImgs = defaultdict(list), defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            imgToAnns[ann["image_id"]].append(ann)
            anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            catToImgs[ann["category_id"]].append(ann["image_id"])
        self.anns, self.cats, self.imgs = anns, cats, imgs
        self.imgToAnns, self.catToImgs = imgToAnns, catToImgs

    # -- query ------------------------------------------------------------
    def getAnnIds(self, imgIds=[], catIds=[], areaRng=[], iscrowd=None):
        imgIds = _as_list(imgIds)
        catIds = _as_list(catIds)
        if len(imgIds) == 0 and len(catIds) == 0 and len(areaRng) == 0:
            anns = self.dataset.get("annotations", [])
        else:
            if len(imgIds) > 0:
                anns = [a for i in imgIds for a in self.imgToAnns[i]]
            else:
                anns = self.dataset.get("annotations", [])
            if len(catIds) > 0:
                catset = set(catIds)
                anns = [a for a in anns if a["category_id"] in catset]
            if len(areaRng) > 0:
                anns = [
                    a for a in anns
                    if areaRng[0] < a["area"] < areaRng[1]
                ]
        if iscrowd is not None:
            return [a["id"] for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=[], supNms=[], catIds=[]):
        cats = list(self.dataset.get("categories", []))
        catNms, supNms, catIds = map(_as_list, (catNms, supNms, catIds))
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in supNms]
        if catIds:
            cats = [c for c in cats if c["id"] in catIds]
        return [c["id"] for c in cats]

    def getImgIds(self, imgIds=[], catIds=[]):
        imgIds = _as_list(imgIds)
        catIds = _as_list(catIds)
        if not imgIds and not catIds:
            return list(self.imgs.keys())
        ids = set(imgIds) if imgIds else None
        for i, catId in enumerate(catIds):
            s = set(self.catToImgs[catId])
            ids = s if ids is None else (ids & s if i > 0 or imgIds else s)
        return list(ids if ids is not None else [])

    def loadAnns(self, ids=[]):
        return [self.anns[i] for i in _as_list(ids)]

    def loadCats(self, ids=[]):
        return [self.cats[i] for i in _as_list(ids)]

    def loadImgs(self, ids=[]):
        return [self.imgs[i] for i in _as_list(ids)]

    # -- results ----------------------------------------------------------
    def loadRes(self, resFile) -> "COCO":
        """Create a result COCO from detection dicts (pycocotools.loadRes)."""
        res = COCO()
        res.dataset["images"] = [img for img in self.dataset.get("images", [])]
        if isinstance(resFile, str):
            with open(resFile) as f:
                anns = json.load(f)
        else:
            anns = copy.deepcopy(resFile)
        assert isinstance(anns, list)
        if not anns:
            res.dataset["annotations"] = []
            res.dataset["categories"] = copy.deepcopy(
                self.dataset.get("categories", [])
            )
            res.createIndex()
            return res
        if "bbox" in anns[0] and anns[0]["bbox"] != []:
            res.dataset["categories"] = copy.deepcopy(self.dataset["categories"])
            for aid, ann in enumerate(anns):
                bb = ann["bbox"]
                if "segmentation" not in ann:
                    ann["segmentation"] = [
                        [bb[0], bb[1], bb[0], bb[1] + bb[3],
                         bb[0] + bb[2], bb[1] + bb[3], bb[0] + bb[2], bb[1]]
                    ]
                ann.setdefault("area", bb[2] * bb[3])
                ann["id"] = aid + 1
                ann.setdefault("iscrowd", 0)
        elif "segmentation" in anns[0]:
            res.dataset["categories"] = copy.deepcopy(self.dataset["categories"])
            for aid, ann in enumerate(anns):
                seg = ann["segmentation"]
                ann.setdefault("area", rle_codec.area(seg))
                if "bbox" not in ann:
                    ann["bbox"] = rle_codec.to_bbox(seg).tolist()
                ann["id"] = aid + 1
                ann.setdefault("iscrowd", 0)
        res.dataset["annotations"] = anns
        res.createIndex()
        return res

    # -- masks ------------------------------------------------------------
    def annToRLE(self, ann):
        img = self.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        segm = ann["segmentation"]
        if isinstance(segm, list):
            rles = rle_codec.frPyObjects(segm, h, w)
            return rle_codec.merge(rles)
        if isinstance(segm.get("counts"), list):
            return rle_codec.frPyObjects(segm, h, w)
        return segm

    def annToMask(self, ann):
        return rle_codec.decode(self.annToRLE(ann))


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]
