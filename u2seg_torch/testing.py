"""A tiny config, a synthetic training batch and a loader of them
(counterparts of ``u2seg_tpu/config/testing.py`` and of the ``fake_loader``
of the JAX package's trainer test), small but complete: cascade heads,
SyncBN, class-agnostic regression. Also numpy-drawn scenes, a synthetic
COCO-format panoptic evaluation set in U2Seg's encoding, and a predictor
that answers with its ground truth in cluster space. Used by the CPU tests,
the data-parallel dry run and ``chip_smoke.py``.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from u2seg_torch.config import Config
from u2seg_torch.engine.trainer import Batch
from u2seg_torch.structures.instances import GtInstances


def tiny_spmd_config() -> Config:
    cfg = Config()
    m = cfg.model
    m.compute_dtype = "float32"
    m.resnet.norm = "SyncBN"
    m.fpn.norm = "SyncBN"
    m.roi_heads.num_classes = 7
    m.roi_heads.batch_size_per_image = 32
    m.roi_heads.detections_per_image = 10
    m.sem_seg_head.num_classes = 5
    m.rpn.pre_nms_topk_train = 64
    m.rpn.post_nms_topk_train = 64
    m.rpn.pre_nms_topk_test = 64
    m.rpn.post_nms_topk_test = 32
    m.rpn.batch_size_per_image = 32
    cfg.solver.warmup_iters = 2
    return cfg


def tiny_batch(rng: np.random.RandomState, b: int = 8, h: int = 64,
               w: int = 64, g: int = 3, patch: int = 32,
               num_classes: int = 7, num_stuff: int = 5) -> Batch:
    """Synthetic training batch matching ``tiny_spmd_config`` shapes (CPU
    tensors; the draws follow the JAX package's ``tiny_batch`` in order)."""
    images = rng.rand(b, h, w, 3).astype(np.float32) * 255
    sizes = np.array([[h, w]] * b, dtype=np.int32)
    xy = rng.rand(b, g, 2) * (h / 2)
    wh = rng.rand(b, g, 2) * (h / 3) + 8
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    classes = rng.randint(0, num_classes, (b, g)).astype(np.int32)
    masks = (rng.rand(b, g, patch, patch) > 0.4).astype(np.float32)
    sem = rng.randint(0, num_stuff, (b, h, w)).astype(np.int32)
    gt = GtInstances(boxes=torch.from_numpy(boxes),
                     classes=torch.from_numpy(classes),
                     valid=torch.ones((b, g), dtype=torch.bool),
                     masks=torch.from_numpy(masks))
    return Batch(images=torch.from_numpy(images),
                 image_sizes=torch.from_numpy(sizes), gt=gt,
                 sem_seg=torch.from_numpy(sem))


def fake_loader(rng: np.random.RandomState, b: int = 8, **shapes):
    """Endless mapper dicts (numpy arrays) of ``tiny_batch(rng, b, **shapes)``
    batches, as ``DefaultTrainer`` takes them."""
    while True:
        t = tiny_batch(rng, b=b, **shapes)
        yield {"image": t.images.numpy(), "image_size": t.image_sizes.numpy(),
               "gt_boxes": t.gt.boxes.numpy(), "gt_classes": t.gt.classes.numpy(),
               "gt_valid": t.gt.valid.numpy(), "gt_masks": t.gt.masks.numpy(),
               "sem_seg": t.sem_seg.numpy()}


def scene(rng, h: int, w: int) -> np.ndarray:
    """A numpy-drawn RGB scene: smooth background + 10-25 solid ellipses."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for ch in range(3):
        a, b_, c_ = rng.rand(3)
        img[..., ch] = 60 + 80 * (a * yy / h + b_ * xx / w + c_) / 3
    for _ in range(rng.randint(10, 25)):
        cy, cx = rng.rand() * h, rng.rand() * w
        ay, ax = rng.randint(18, 90), rng.randint(18, 90)
        th = rng.rand() * np.pi
        dy, dx = yy - cy, xx - cx
        u = (dx * np.cos(th) + dy * np.sin(th)) / ax
        v = (-dx * np.sin(th) + dy * np.cos(th)) / ay
        img[u * u + v * v <= 1.0] = rng.rand(3) * 255
    return img.clip(0, 255)


# ---------------------------------------------------------------------------
# a synthetic COCO-format panoptic evaluation set
# ---------------------------------------------------------------------------

@dataclass
class SyntheticCoco:
    """Where ``write_synthetic_coco`` put a set."""
    image_dir: str
    sem_seg_dir: str
    panoptic_dir: str
    instances_json: str
    panoptic_json: str
    cluster_num: int
    image_ids: List[int]


def _distinct_ids(rng: np.random.RandomState, n: int) -> List[int]:
    ids: List[int] = []
    while len(ids) < n:
        i = int(rng.randint(1, 1 << 24))
        if i not in ids:
            ids.append(i)
    return ids


def write_synthetic_coco(root: str, sizes: Sequence[Tuple[int, int]],
                         rng: np.random.RandomState,
                         cluster_num: int = 800) -> SyntheticCoco:
    """Write a COCO-format panoptic evaluation set in U2Seg's encoding under
    ``root``, every file a PNG written through ``data.image_io`` (Pillow):
      - RGB scenes ``{id:012d}.png`` of the given (h, w);
      - an instances JSON listing the 80 COCO thing categories, with 2-6
        non-overlapping boxes per image over real COCO thing ids (polygon
        segmentations of the boxes);
      - a panoptic JSON with RGB id PNGs: the boxes as thing segments (their
        COCO ids), 2-3 horizontal stuff bands of distinct supercategories as
        stuff segments at ``cluster_num + supercategory``, and a void strip
        at the bottom (id 0); segment ids are random 24-bit numbers;
      - sem-seg GT PNGs in the contiguous-stuff encoding (0 things, 1..53
        stuff, 255 void)."""
    from u2seg_torch.data.builtin_meta import (
        COCO_PANOPTIC_CATEGORIES, NUM_SUPERCATEGORIES, STUFF_TO_SUPERCATEGORY,
        stuff_dataset_id_to_contiguous_id, stuff_ids, thing_ids,
    )
    from u2seg_torch.data.image_io import write_panoptic_png, write_png

    dirs = [os.path.join(root, d) for d in ("images", "sem_seg", "panoptic")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    things, stuffs = thing_ids(), stuff_ids()
    stuff_contig = stuff_dataset_id_to_contiguous_id()
    images, anns, pan_anns, ids = [], [], [], []
    for n, (h, w) in enumerate(sizes):
        image_id = 100 + 7 * n
        name = f"{image_id:012d}.png"
        write_png(os.path.join(dirs[0], name), scene(rng, h, w).astype(np.uint8))
        void = max(2, h // 20)
        pan = np.zeros((h, w), np.int64)
        sem = np.full((h, w), 255, np.uint8)
        kinds = {}
        nb = int(rng.randint(2, 4))
        bands, seen = [], set()
        while len(bands) < nb:
            sid = stuffs[rng.randint(len(stuffs))]
            if STUFF_TO_SUPERCATEGORY[sid] not in seen:
                seen.add(STUFF_TO_SUPERCATEGORY[sid])
                bands.append(sid)
        cuts = np.linspace(0, h - void, nb + 1).astype(int)
        nt = int(rng.randint(2, 7))
        seg_ids = _distinct_ids(rng, nb + nt)
        for j, sid in enumerate(bands):
            pan[cuts[j]:cuts[j + 1]] = seg_ids[j]
            sem[cuts[j]:cuts[j + 1]] = stuff_contig[sid]
            kinds[seg_ids[j]] = cluster_num + STUFF_TO_SUPERCATEGORY[sid]
        ch, cw = (h - void) // 3, w // 3
        for j, cell in enumerate(rng.permutation(9)[:nt].tolist()):
            y0 = (cell // 3) * ch + int(rng.randint(0, max(1, ch // 4)))
            x0 = (cell % 3) * cw + int(rng.randint(0, max(1, cw // 4)))
            y1 = y0 + int(rng.randint(ch // 2, ch - ch // 4 + 1))
            x1 = x0 + int(rng.randint(cw // 2, cw - cw // 4 + 1))
            tid = things[rng.randint(len(things))]
            sid = seg_ids[nb + j]
            pan[y0:y1, x0:x1] = sid
            sem[y0:y1, x0:x1] = 0
            kinds[sid] = tid
            anns.append({
                "id": len(anns) + 1, "image_id": image_id, "category_id": tid,
                "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                "area": float((x1 - x0) * (y1 - y0)), "iscrowd": 0,
                "segmentation": [[x0, y0, x1, y0, x1, y1, x0, y1]],
            })
        write_png(os.path.join(dirs[1], name), sem)
        write_panoptic_png(pan, os.path.join(dirs[2], name))
        segments = []
        for sid, cat in kinds.items():
            ys, xs = np.nonzero(pan == sid)
            segments.append({
                "id": sid, "category_id": cat, "iscrowd": 0, "area": int(len(ys)),
                "bbox": [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                         int(ys.max() - ys.min() + 1)],
            })
        images.append({"id": image_id, "file_name": name, "height": h, "width": w})
        pan_anns.append({"image_id": image_id, "file_name": name,
                         "segments_info": segments})
        ids.append(image_id)
    thing_cats = [{"id": c[0], "name": c[2], "supercategory": c[3]}
                  for c in COCO_PANOPTIC_CATEGORIES if c[1] == 1]
    inst_json = os.path.join(root, "instances.json")
    with open(inst_json, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": thing_cats}, f)
    pan_json = os.path.join(root, "panoptic.json")
    with open(pan_json, "w") as f:
        json.dump({"images": images, "annotations": pan_anns, "categories": [
            dict(c, isthing=1) for c in thing_cats] + [
            {"id": cluster_num + s, "name": f"super_{s}", "isthing": 0}
            for s in range(1, NUM_SUPERCATEGORIES + 1)]}, f)
    return SyntheticCoco(*dirs, inst_json, pan_json, cluster_num, ids)


def register_synthetic_coco(name: str, ds: SyntheticCoco) -> None:
    """Register a set of ``write_synthetic_coco`` in the port's catalogs, as
    the JAX package's evaluation test registers its own (instances merged
    with the sem-seg GT by file name; panoptic JSON and root as metadata)."""
    from u2seg_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from u2seg_torch.data.coco import load_coco_json, load_sem_seg, merge_to_panoptic

    if name in DatasetCatalog:
        DatasetCatalog.remove(name)
    if name in MetadataCatalog.list():
        MetadataCatalog.remove(name)
    DatasetCatalog.register(name, lambda: merge_to_panoptic(
        load_coco_json(ds.instances_json, ds.image_dir, name),
        load_sem_seg(ds.sem_seg_dir, ds.image_dir, image_ext="png")))
    MetadataCatalog.get(name).set(
        json_file=ds.instances_json, panoptic_json=ds.panoptic_json,
        panoptic_root=ds.panoptic_dir)


def _oracle_thing_cluster(contiguous: int, cluster_num: int) -> int:
    """The cluster an oracle gives COCO thing class ``contiguous`` (0..79):
    one of its own for each class while gcd(7, cluster_num) = 1."""
    return (7 * contiguous + 3) % cluster_num


def _oracle_stuff_cluster(supercategory: int) -> int:
    """The semantic cluster (6..20 of 27) an oracle gives a supercategory."""
    return supercategory + 5


class OraclePredictor:
    """Answers every image with its own ground truth in cluster space, read
    from the example's GT fields: boxes of the thing segments with their
    thing cluster and score 0.95, the semantic map with stuff clusters (0
    on things and void), the panoptic map with segments of cluster ids.

    With ``supervised=True`` it answers as a supervised model would:
    contiguous thing classes (0..79), stuff segments by supercategory, and
    the contiguous-stuff semantic map itself.

    ``run_batched`` yields images grouped by orientation, wide first, in
    groups of ``batch_size``: the same reordering as
    ``DefaultPredictor.run_batched``'s buckets."""

    def __init__(self, cluster_num: int, supervised: bool = False):
        from u2seg_torch.data.builtin_meta import thing_dataset_id_to_contiguous_id

        self.cluster_num = cluster_num
        self.supervised = supervised
        self._contig = thing_dataset_id_to_contiguous_id()

    def answer(self, inp: dict) -> dict:
        from u2seg_torch.evaluation.sem_seg_evaluator import (
            transfer_gt_to_supercategories,
        )

        gt = inp["sem_seg_gt"]
        sup = transfer_gt_to_supercategories(gt)
        stuff = (sup >= 1) & (sup <= 15)
        if self.supervised:
            sem = np.where(stuff, gt, 0).astype(np.int64)
        else:
            sem = np.where(stuff, _oracle_stuff_cluster(sup), 0).astype(np.int64)
        boxes, classes, segments = [], [], []
        for s in inp["gt_segments"]:
            if s["category_id"] > self.cluster_num:
                s_id = s["category_id"] - self.cluster_num
                segments.append({"id": s["id"], "isthing": False, "category_id":
                                 s_id if self.supervised else _oracle_stuff_cluster(s_id)})
                continue
            cl = self._contig[s["category_id"]]
            if not self.supervised:
                cl = _oracle_thing_cluster(cl, self.cluster_num)
            x, y, w, h = s["bbox"]
            boxes.append([x, y, x + w, y + h])
            classes.append(cl)
            segments.append({"id": s["id"], "isthing": True, "category_id": cl,
                             "score": 0.95})
        return {
            "instances": {"boxes": np.asarray(boxes, np.float64).reshape(-1, 4),
                          "scores": np.full(len(boxes), 0.95),
                          "classes": np.asarray(classes, np.int64)},
            "sem_seg": sem, "panoptic": inp["pan_gt"].copy(), "segments": segments,
        }

    def run_batched(self, examples, batch_size: int = 4, **_):
        groups = defaultdict(list)
        for inp, img in examples:
            g = groups[img.shape[0] > img.shape[1]]
            g.append(inp)
            if len(g) == batch_size:
                yield from ((i, self.answer(i)) for i in g)
                g.clear()
        for g in groups.values():
            yield from ((i, self.answer(i)) for i in g)
