"""DensePose data pipeline: COCO-DensePose annotations -> fixed-capacity
training arrays (counterpart of ``u2seg_tpu/projects/densepose_data.py``).

Counterpart of ``projects/DensePose/densepose/structures/data_relative.py``
(DensePoseDataRelative: dp_x/dp_y in [0,255] normalized to the GT box,
dp_I in 0..24, dp_U/dp_V in [0,1], dp_masks = 14 per-part RLEs on a
256x256 box-relative canvas) and ``densepose/data/dataset_mapper.py``.

The reference keeps ragged per-instance point lists and a 256x256 tensor;
here every image yields FIXED arrays: (G, P) point annotations and (G, S,
S) part-label rasters with the same ``max_gt`` capacity as the detection
GT. The raster is resized as ``cv2.resize(..., INTER_NEAREST)`` resizes it
(``data.transforms.resize_nearest``).

Horizontal flip applies the published part symmetries
(``structures/transform_data.py:22-24``: MASK_LABEL_SYMMETRIES /
POINT_LABEL_SYMMETRIES). The reference additionally remaps U/V through
texture-space symmetry tables loaded from an external
``UV_symmetry_transforms.mat`` download; that data file cannot be bundled,
so U/V are kept unchanged under flip (set ``densepose_hflip=False`` on the
mapper to disable flip instead when exact U/V supervision matters).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

from u2seg_torch.data import transforms as T
from u2seg_torch.data.mapper import DatasetMapper
from u2seg_torch.evaluation import rle as rle_codec

logger = logging.getLogger(__name__)

# Published horizontal-flip label symmetries (transform_data.py:22-24).
# Mask parts: 0=bg, then 14 coarse parts; points: 0=bg, then 24 fine charts.
MASK_LABEL_SYMMETRIES = np.array(
    [0, 1, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 13, 12, 14], np.uint8
)
POINT_LABEL_SYMMETRIES = np.array(
    [0, 1, 2, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13,
     16, 15, 18, 17, 20, 19, 22, 21, 24, 23], np.int32
)

DP_MASK_SIZE = 256      # annotation canvas (data_relative.py MASK_SIZE)
DP_N_BODY_PARTS = 14
DP_N_PART_LABELS = 24
DP_MAX_POINTS = 196     # observed max annotated points per DensePose inst.


def decode_dp_masks(poly_specs) -> np.ndarray:
    """dp_masks (list of up to 14 per-part RLEs on 256x256) -> (256, 256)
    uint8 part-label raster, later parts overwriting earlier ones
    (ref data_relative.py extract_segmentation_mask)."""
    segm = np.zeros((DP_MASK_SIZE, DP_MASK_SIZE), np.uint8)
    if isinstance(poly_specs, dict):
        if poly_specs:
            segm[rle_codec.decode(poly_specs) > 0] = 1
        return segm
    for i, poly in enumerate(poly_specs):
        if poly:
            segm[rle_codec.decode(poly) > 0] = i + 1
    return segm


@dataclasses.dataclass
class DensePoseRawData:
    """One instance's annotations, GT-box-relative (xy already /256)."""

    xy: np.ndarray       # (P, 2) float32 in [0, 1] wrt the GT box
    i: np.ndarray        # (P,) int32 fine chart label 1..24
    u: np.ndarray        # (P,) float32
    v: np.ndarray        # (P,) float32
    point_valid: np.ndarray  # (P,) bool
    segm: np.ndarray     # (S, S) uint8 part labels 0..14


def parse_densepose_annotation(
    ann: dict, max_points: int = DP_MAX_POINTS, segm_size: int = DP_MASK_SIZE,
) -> Optional[DensePoseRawData]:
    """COCO-DensePose annotation dict -> fixed arrays, or None if the
    annotation carries no densepose data (validate_annotation analog)."""
    if "dp_x" not in ann or "dp_y" not in ann:
        return None
    x = np.asarray(ann["dp_x"], np.float32) / DP_MASK_SIZE
    y = np.asarray(ann["dp_y"], np.float32) / DP_MASK_SIZE
    n = min(len(x), max_points)
    xy = np.zeros((max_points, 2), np.float32)
    i_lab = np.zeros((max_points,), np.int32)
    u = np.zeros((max_points,), np.float32)
    v = np.zeros((max_points,), np.float32)
    pv = np.zeros((max_points,), bool)
    xy[:n, 0] = x[:n]
    xy[:n, 1] = y[:n]
    if "dp_I" in ann:
        i_lab[:n] = np.asarray(ann["dp_I"], np.float64)[:n].astype(np.int32)
        u[:n] = np.clip(np.asarray(ann["dp_U"], np.float32)[:n], 0.0, 1.0)
        v[:n] = np.clip(np.asarray(ann["dp_V"], np.float32)[:n], 0.0, 1.0)
    pv[:n] = True
    segm = (decode_dp_masks(ann["dp_masks"]) if "dp_masks" in ann
            else np.zeros((DP_MASK_SIZE, DP_MASK_SIZE), np.uint8))
    if segm_size != DP_MASK_SIZE:
        segm = T.resize_nearest(segm, segm_size, segm_size)
    return DensePoseRawData(xy, i_lab, u, v, pv, segm)


def flip_densepose(data: DensePoseRawData) -> DensePoseRawData:
    """Horizontal flip in GT-box-relative space: x -> 1 - x, chart/part
    labels through the published symmetries, the raster mirrored
    (ref data_relative.py:177-240 _transform_pts/_transform_segm; the
    U/V texture remap needs the external symmetry tables — see module
    docstring)."""
    xy = data.xy.copy()
    xy[:, 0] = np.where(data.point_valid, 1.0 - xy[:, 0], xy[:, 0])
    i = POINT_LABEL_SYMMETRIES[np.clip(data.i, 0, DP_N_PART_LABELS)]
    segm = MASK_LABEL_SYMMETRIES[data.segm[:, ::-1]]
    return DensePoseRawData(xy, i.astype(np.int32), data.u.copy(),
                            data.v.copy(), data.point_valid.copy(), segm)


def pack_densepose_gt(
    per_instance: Sequence[Optional[DensePoseRawData]],
    max_gt: int, max_points: int = DP_MAX_POINTS,
    segm_size: int = DP_MASK_SIZE,
) -> Dict[str, np.ndarray]:
    """Stack per-instance raw data (None for instances without densepose)
    into the fixed (G, ...) arrays the train step consumes."""
    g = max_gt
    out = {
        "dp_xy": np.zeros((g, max_points, 2), np.float32),
        "dp_i": np.zeros((g, max_points), np.int32),
        "dp_u": np.zeros((g, max_points), np.float32),
        "dp_v": np.zeros((g, max_points), np.float32),
        "dp_point_valid": np.zeros((g, max_points), bool),
        "dp_segm": np.zeros((g, segm_size, segm_size), np.uint8),
        "dp_valid": np.zeros((g,), bool),
    }
    for k, data in enumerate(per_instance[:g]):
        if data is None:
            continue
        out["dp_xy"][k] = data.xy
        out["dp_i"][k] = data.i
        out["dp_u"][k] = data.u
        out["dp_v"][k] = data.v
        out["dp_point_valid"][k] = data.point_valid
        out["dp_segm"][k] = data.segm
        out["dp_valid"][k] = True
    return out


class DensePoseDatasetMapper(DatasetMapper):
    """DatasetMapper that additionally emits the densepose GT arrays.

    Counterpart of ``densepose/data/dataset_mapper.py:25-119``: the base
    geometric pipeline is unchanged (densepose coordinates are GT-box
    relative, hence invariant to resize/crop box transforms); horizontal
    flip is detected from the sampled transform list and applied in
    box-relative space. Rotation augs are unsupported for densepose GT
    (as in practice in the reference, whose densepose configs use
    ResizeShortestEdge + flip only).
    """

    def __init__(self, cfg, is_train: bool = True, mask_patch_size: int = 64,
                 max_points: int = DP_MAX_POINTS, segm_size: int = 128,
                 densepose_hflip: bool = True):
        super().__init__(cfg, is_train, mask_patch_size)
        self.max_points = max_points
        self.segm_size = segm_size
        if not densepose_hflip:
            self.augs = T.AugmentationList([
                a for a in self.augs.augs
                if not isinstance(a, T.RandomFlip)
            ])

    def __call__(self, dataset_dict: dict, rng=None):
        rng = rng or np.random.RandomState()
        # Run the base path with a fixed-seed rng copy so the sampled
        # transform can be replayed (shape + rng fully determine the draw).
        seed = rng.randint(0, 2 ** 31 - 1)
        out = super().__call__(dataset_dict, np.random.RandomState(seed))
        if out is None or not self.is_train:
            return out

        # Recover whether the sampled transform flips horizontally by
        # replaying the augmentation draw with the same seed on a
        # same-shaped probe (all our augs sample from shape + rng only).
        image_shape = (dataset_dict.get("height", 1),
                       dataset_dict.get("width", 1))
        probe = np.zeros((*image_shape, 3), np.uint8)
        tfm = self.augs.get_transform(probe, np.random.RandomState(seed))
        flipped = _is_hflip(tfm)

        # gt_ann_index maps each kept GT slot back to its (non-crowd)
        # annotation, skipping whatever the base filters dropped.
        anns = [a for a in dataset_dict.get("annotations", [])
                if a.get("iscrowd", 0) == 0]
        per_inst: List[Optional[DensePoseRawData]] = []
        for ann_i in out["gt_ann_index"]:
            data = None
            if ann_i >= 0:
                data = parse_densepose_annotation(
                    anns[ann_i], self.max_points, self.segm_size)
                if data is not None and flipped:
                    data = flip_densepose(data)
            per_inst.append(data)
        out.update(pack_densepose_gt(
            per_inst, self.max_gt, self.max_points, self.segm_size))
        return out


def _is_hflip(tfm) -> bool:
    """True if the composed transform flips horizontally an odd number of
    times (ref data_relative.py:181: 'HFlipTransform is the only one that
    does flip')."""

    def count(t) -> int:
        if isinstance(t, T.TransformList):
            return sum(count(s) for s in t.tfms)
        return int(isinstance(t, T.HFlipTransform))

    return count(tfm) % 2 == 1


def load_densepose_coco_json(json_file: str, image_root: str,
                             dataset_name: Optional[str] = None) -> List[dict]:
    """COCO-DensePose json -> dataset dicts; keeps dp_* keys on the
    annotations (ref densepose/data/datasets/coco.py load path keeps the
    DensePoseDataRelative keys on each obj)."""
    from u2seg_torch.data.coco import load_coco_json

    return load_coco_json(
        json_file, image_root, dataset_name,
        extra_annotation_keys=["dp_x", "dp_y", "dp_I", "dp_U", "dp_V",
                               "dp_masks"],
    )
