"""DatasetMapper: dataset dict -> fixed-size training example (numpy)
(counterpart of ``u2seg_tpu/data/mapper.py``; detectron2's
``dataset_mapper.py`` with the parts of ``detection_utils.py`` it uses).

Every output has a fixed size: boxes and classes padded to ``max_gt`` with
a valid mask, GT masks as box-relative ``P x P`` patches (the targets of
``roi_heads.mask_targets_from_patches``), the augmented image padded into
one of a few static buckets with its true (h, w) beside it. Images and
sem-seg maps are read through Pillow (``data.image_io``).
"""
from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import numpy as np

from u2seg_torch.config import Config
from u2seg_torch.data import transforms as T
from u2seg_torch.data.image_io import read_image, read_sem_seg
from u2seg_torch.evaluation import rle as rle_codec
from u2seg_torch.structures.masks import polygons_to_bitmask

logger = logging.getLogger(__name__)


def _count_hflips(t) -> int:
    sub = getattr(t, "tfms", None)
    if sub is not None:
        return sum(_count_hflips(s) for s in sub)
    return int(isinstance(t, T.HFlipTransform))


def transform_keypoint_annotations(
    keypoints, tfm, image_size: Tuple[int, int],
    keypoint_hflip_indices: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """COCO (K*3,) keypoints -> transformed (K, 3) float64: coords through
    the composed transform, points outside the image unlabeled (v=0, coords
    zeroed as COCO does), left/right identities swapped under an odd number
    of horizontal flips."""
    kp = np.asarray(keypoints, np.float64).reshape(-1, 3)
    xy = tfm.apply_coords(kp[:, :2].copy())
    inside = ((xy >= 0) & (xy <= np.array(image_size[::-1]))).all(axis=1)
    kp[:, :2] = xy
    kp[~inside, 2] = 0
    if _count_hflips(tfm) % 2 == 1:
        if keypoint_hflip_indices is None:
            raise ValueError("flip sampled but no keypoint_hflip_indices")
        kp = kp[np.asarray(keypoint_hflip_indices, np.int32)]
    kp[kp[:, 2] == 0] = 0
    return kp


def segmentation_to_mask(segm, h: int, w: int) -> np.ndarray:
    """COCO segmentation (polygons, RLE dict or array) -> bool (h, w)."""
    if isinstance(segm, list):
        return polygons_to_bitmask([np.asarray(p) for p in segm], h, w)
    if isinstance(segm, dict):
        return rle_codec.decode(segm).astype(bool)
    if isinstance(segm, np.ndarray):
        return segm.astype(bool)
    raise TypeError(f"Unknown segmentation type {type(segm)}")


class DatasetMapper:
    def __init__(self, cfg: Config, is_train: bool = True,
                 mask_patch_size: int = 64):
        self.is_train = is_train
        self.cfg = cfg
        self.augs = T.build_augmentation(cfg.input, is_train)
        self.max_gt = cfg.model.max_gt_instances
        self.mask_on = cfg.model.mask_on
        self.keypoint_on = cfg.model.keypoint_on
        if self.keypoint_on:
            from u2seg_torch.data.builtin_meta import create_keypoint_hflip_indices

            self.kp_hflip_indices = create_keypoint_hflip_indices()
        self.mask_patch = mask_patch_size
        self.buckets = tuple(cfg.input.pad_buckets)
        self.image_format = cfg.model.input_format

    def _patch(self, segm, orig_hw, tfm, box) -> Optional[np.ndarray]:
        """The instance's mask, transformed with the image, cropped to the
        integer hull of its box and resampled to P x P (None: empty crop)."""
        mask = segmentation_to_mask(segm, *orig_hw)
        mask = tfm.apply_segmentation(mask.astype(np.uint8))
        x0, y0, x1, y1 = (int(np.floor(box[0])), int(np.floor(box[1])),
                          int(np.ceil(box[2])), int(np.ceil(box[3])))
        crop = mask[max(y0, 0):max(y1, y0 + 1), max(x0, 0):max(x1, x0 + 1)]
        if crop.size == 0:
            return None
        return T.resize_bilinear(crop.astype(np.float32), self.mask_patch, self.mask_patch)

    def __call__(self, dataset_dict: dict,
                 rng: Optional[np.random.RandomState] = None) -> Optional[dict]:
        rng = rng or np.random.RandomState()
        dd = dict(dataset_dict)
        image = read_image(dd["file_name"], self.image_format)
        orig_h, orig_w = image.shape[:2]

        sem_seg = None
        if "sem_seg_file_name" in dd:
            sem_seg = read_sem_seg(dd["sem_seg_file_name"]).astype(np.uint8)

        tfm = self.augs.get_transform(image, rng, sem_seg=sem_seg)
        image = tfm.apply_image(image)
        h, w = image.shape[:2]
        if sem_seg is not None:
            sem_seg = tfm.apply_segmentation(sem_seg)

        # instances -> fixed-size arrays
        g = self.max_gt
        boxes = np.zeros((g, 4), np.float32)
        classes = np.zeros((g,), np.int32)
        valid = np.zeros((g,), bool)
        ann_index = np.full((g,), -1, np.int32)
        patches = np.zeros((g, self.mask_patch, self.mask_patch), np.float32)
        keypoints = (np.zeros((g, len(self.kp_hflip_indices), 3), np.float32)
                     if self.keypoint_on else None)

        anns = [a for a in dd.get("annotations", []) if a.get("iscrowd", 0) == 0]
        kept = 0
        for ann_i, ann in enumerate(anns):
            if kept >= g:
                logger.warning("image %s has more than %d instances; truncating",
                               dd.get("image_id"), g)
                break
            x, y, bw, bh = ann["bbox"]
            box = tfm.apply_box(np.array([[x, y, x + bw, y + bh]], np.float64))[0]
            box[0::2] = np.clip(box[0::2], 0, w)
            box[1::2] = np.clip(box[1::2], 0, h)
            if box[2] - box[0] <= 1e-3 or box[3] - box[1] <= 1e-3:
                continue
            if self.mask_on and self.is_train:
                segm = ann.get("segmentation")
                if segm is None:
                    continue
                patch = self._patch(segm, (orig_h, orig_w), tfm, box)
                if patch is None:
                    continue
                patches[kept] = patch
            if keypoints is not None and "keypoints" in ann:
                keypoints[kept] = transform_keypoint_annotations(
                    ann["keypoints"], tfm, (h, w), self.kp_hflip_indices)
            boxes[kept] = box
            classes[kept] = ann["category_id"]
            valid[kept] = True
            ann_index[kept] = ann_i      # the slot among the non-crowd annotations
            kept += 1

        if self.is_train and kept == 0 and anns:
            return None                  # the loader draws another image

        # bucket padding; a size no bucket fits is scaled down into the largest
        bh, bw = T.pick_bucket(h, w, self.buckets)
        if h > bh or w > bw:
            scale = min(bh / h, bw / w)
            new_h, new_w = int(h * scale), int(w * scale)
            rescale = T.ResizeTransform(h, w, new_h, new_w)
            image = rescale.apply_image(image)
            boxes[:kept] = rescale.apply_box(boxes[:kept])
            if keypoints is not None and kept:
                flat = keypoints[:kept, :, :2].reshape(-1, 2)
                keypoints[:kept, :, :2] = rescale.apply_coords(flat).reshape(kept, -1, 2)
            if sem_seg is not None:
                sem_seg = rescale.apply_segmentation(sem_seg)
            h, w = new_h, new_w
        padded = np.zeros((bh, bw, 3), np.float32)
        padded[:h, :w] = image.astype(np.float32)
        out = {
            "image": padded,
            "image_size": np.array([h, w], np.int32),
            "gt_boxes": boxes,
            "gt_classes": classes,
            "gt_valid": valid,
            "gt_ann_index": ann_index,
            "gt_masks": patches,
            **({"gt_keypoints": keypoints} if keypoints is not None else {}),
            "image_id": dd.get("image_id", 0),
            "height": dd.get("height", orig_h),
            "width": dd.get("width", orig_w),
            "scale": np.array(
                [dd.get("height", orig_h) / h, dd.get("width", orig_w) / w], np.float32),
            "bucket": (bh, bw),
        }
        if sem_seg is not None:
            pad_seg = np.full((bh, bw), 255, np.uint8)
            pad_seg[:h, :w] = sem_seg
            out["sem_seg"] = pad_seg.astype(np.int32)
        return out
