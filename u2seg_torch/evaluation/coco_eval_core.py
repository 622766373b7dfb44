"""COCO AP evaluation core, pycocotools' ``COCOeval`` on the host (counterpart
of ``u2seg_tpu/evaluation/coco_eval_core.py``): score-sorted greedy matching
with crowd handling, 101-point interpolated precision, the summarize table;
bbox, segm and keypoints.

Mask IoU, box IoU and the greedy matching run in the host C++ of
``u2seg_torch/_native`` (built with g++ at first use; it raises where it
cannot be built), as the JAX package's do where g++ built its library. Their
numpy twins (``rle._iou_plain``, ``_bbox_iou_xywh``, ``_match_plain``, used
together by ``PlainCOCOeval``) give the same results and are the references
the tests hold the C++ against.
"""
from __future__ import annotations

import copy
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from u2seg_torch import _native
from u2seg_torch.evaluation import rle as rle_codec
from u2seg_torch.evaluation.coco_api import COCO


# COCO 17-keypoint OKS falloff constants (pycocotools cocoeval.py:523)
COCO_KPT_OKS_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
     1.07, 1.07, .87, .87, .89, .89]) / 10.0


class Params:
    def __init__(self, iouType="segm"):
        self.imgIds: List[int] = []
        self.catIds: List[int] = []
        self.iouThrs = np.linspace(0.5, 0.95, 10)
        self.recThrs = np.linspace(0.0, 1.00, 101)
        if iouType == "keypoints":
            # setKpParams (pycocotools cocoeval.py:510-524)
            self.maxDets = [20]
            self.areaRng = [
                [0, 1e5 ** 2], [32 ** 2, 96 ** 2], [96 ** 2, 1e5 ** 2]
            ]
            self.areaRngLbl = ["all", "medium", "large"]
            self.kpt_oks_sigmas = COCO_KPT_OKS_SIGMAS.copy()
        else:
            self.maxDets = [1, 10, 100]
            self.areaRng = [
                [0, 1e5 ** 2], [0, 32 ** 2], [32 ** 2, 96 ** 2],
                [96 ** 2, 1e5 ** 2]
            ]
            self.areaRngLbl = ["all", "small", "medium", "large"]
        self.useCats = 1
        self.iouType = iouType


class COCOeval:
    #: (D, G) mask IoU, (D, G) XYWH box IoU and the per-image greedy
    #: matching: the host C++ of ``u2seg_torch/_native``. ``PlainCOCOeval``
    #: (below) names the numpy twins instead.
    mask_iou = staticmethod(rle_codec.iou)
    box_iou = staticmethod(_native.bbox_iou)
    greedy_match = staticmethod(_native.cocoeval_match)

    def __init__(self, cocoGt: Optional[COCO] = None, cocoDt: Optional[COCO] = None,
                 iouType: str = "segm"):
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.evalImgs: dict = defaultdict(list)
        self.eval: dict = {}
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        self.params = Params(iouType)
        self.stats: np.ndarray = np.array([])
        self.ious: dict = {}
        if cocoGt is not None:
            self.params.imgIds = sorted(cocoGt.getImgIds())
            self.params.catIds = sorted(cocoGt.getCatIds())

    # ------------------------------------------------------------------
    def _prepare(self):
        p = self.params
        gts = self.cocoGt.loadAnns(
            self.cocoGt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds if p.useCats else [])
        )
        dts = self.cocoDt.loadAnns(
            self.cocoDt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds if p.useCats else [])
        )
        if p.iouType == "segm":
            for ann in gts:
                ann["rle"] = self.cocoGt.annToRLE(ann)
            for ann in dts:
                ann["rle"] = self.cocoDt.annToRLE(ann)
        for gt in gts:
            gt["ignore"] = gt.get("ignore", 0) or gt.get("iscrowd", 0)
            if p.iouType == "keypoints":
                # GT without labeled keypoints never scores (cocoeval:116)
                gt["ignore"] = gt.get("num_keypoints", 0) == 0 or gt["ignore"]
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for gt in gts:
            self._gts[gt["image_id"], gt["category_id"]].append(gt)
        for dt in dts:
            self._dts[dt["image_id"], dt["category_id"]].append(dt)
        self.evalImgs = defaultdict(list)
        self.eval = {}

    # ------------------------------------------------------------------
    def evaluate(self):
        p = self.params
        p.imgIds = list(np.unique(p.imgIds))
        if p.useCats:
            p.catIds = list(np.unique(p.catIds))
        p.maxDets = sorted(p.maxDets)
        self._prepare()
        catIds = p.catIds if p.useCats else [-1]
        self.ious = {
            (imgId, catId): self.computeIoU(imgId, catId)
            for imgId in p.imgIds for catId in catIds
        }
        maxDet = p.maxDets[-1]
        self.evalImgs = [
            self.evaluateImg(imgId, catId, areaRng, maxDet)
            for catId in catIds
            for areaRng in p.areaRng
            for imgId in p.imgIds
        ]
        self._paramsEval = copy.deepcopy(self.params)

    def computeIoU(self, imgId, catId):
        p = self.params
        if p.useCats:
            gt = self._gts[imgId, catId]
            dt = self._dts[imgId, catId]
        else:
            gt = [g for c in p.catIds for g in self._gts[imgId, c]]
            dt = [d for c in p.catIds for d in self._dts[imgId, c]]
        if len(gt) == 0 or len(dt) == 0:
            return np.zeros((0, 0))
        inds = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in inds]
        if len(dt) > p.maxDets[-1]:
            dt = dt[: p.maxDets[-1]]
        if p.iouType == "segm":
            g = [g_["rle"] for g_ in gt]
            d = [d_["rle"] for d_ in dt]
            iscrowd = [int(o.get("iscrowd", 0)) for o in gt]
            return self.mask_iou(d, g, iscrowd)
        elif p.iouType == "bbox":
            g = np.array([g_["bbox"] for g_ in gt], dtype=np.float64)
            d = np.array([d_["bbox"] for d_ in dt], dtype=np.float64)
            iscrowd = np.array([int(o.get("iscrowd", 0)) for o in gt])
            return self.box_iou(d, g, iscrowd)
        elif p.iouType == "keypoints":
            return self.computeOks(dt, gt)
        raise ValueError(p.iouType)

    def computeOks(self, dts, gts):
        """Object-keypoint-similarity matrix (pycocotools cocoeval.py
        computeOks :203-252): per GT keypoint k, oks contribution
        exp(-d^2 / (2 * area * (2*sigma_k)^2)) averaged over labeled
        keypoints; for GT with no labeled keypoints, distances are
        measured to the 2x-expanded GT box."""
        p = self.params
        sigmas = np.asarray(p.kpt_oks_sigmas, np.float64)
        variances = (sigmas * 2.0) ** 2
        k = len(sigmas)
        ious = np.zeros((len(dts), len(gts)))
        for j, gt in enumerate(gts):
            g = np.asarray(gt["keypoints"], np.float64)
            xg, yg, vg = g[0::3], g[1::3], g[2::3]
            k1 = np.count_nonzero(vg > 0)
            bb = gt["bbox"]
            x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
            y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
            for i, dt in enumerate(dts):
                d = np.asarray(dt["keypoints"], np.float64)
                xd, yd = d[0::3], d[1::3]
                if k1 > 0:
                    dx, dy = xd - xg, yd - yg
                else:
                    z = np.zeros((k,))
                    dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                    dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
                e = ((dx ** 2 + dy ** 2) / variances
                     / (gt["area"] + np.spacing(1)) / 2.0)
                if k1 > 0:
                    e = e[vg > 0]
                ious[i, j] = np.sum(np.exp(-e)) / e.shape[0]
        return ious

    def evaluateImg(self, imgId, catId, aRng, maxDet):
        p = self.params
        if p.useCats:
            gt = self._gts[imgId, catId]
            dt = self._dts[imgId, catId]
        else:
            gt = [g for c in p.catIds for g in self._gts[imgId, c]]
            dt = [d for c in p.catIds for d in self._dts[imgId, c]]
        if len(gt) == 0 and len(dt) == 0:
            return None

        for g in gt:
            g["_ignore"] = 1 if (
                g["ignore"] or g["area"] < aRng[0] or g["area"] > aRng[1]
            ) else 0
        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[0:maxDet]]
        iscrowd = [int(o.get("iscrowd", 0)) for o in gt]
        ious = (
            self.ious[imgId, catId][:, gtind]
            if len(self.ious[imgId, catId]) > 0
            else self.ious[imgId, catId]
        )

        T = len(p.iouThrs)
        G = len(gt)
        D = len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gtIg = np.array([g["_ignore"] for g in gt])
        dtIg = np.zeros((T, D))
        out_of_area = np.array(
            [d["area"] < aRng[0] or d["area"] > aRng[1] for d in dt], bool)
        if len(ious) != 0:
            n_dtm, n_gtm, n_dti = self.greedy_match(
                ious[:D], gtIg.astype(np.uint8), np.asarray(iscrowd, np.uint8),
                np.asarray(p.iouThrs, np.float64), out_of_area.astype(np.uint8))
            # 1-based match indices -> the matched annotation's id (0: none)
            gt_ids = np.array([g["id"] for g in gt], np.int64)
            dt_ids = np.array([d["id"] for d in dt], np.int64)
            dtm = np.where(n_dtm > 0, gt_ids[np.maximum(n_dtm - 1, 0)], 0).astype(float)
            gtm = np.where(n_gtm > 0, dt_ids[np.maximum(n_gtm - 1, 0)], 0).astype(float)
            dtIg = n_dti.astype(float)
        dtIg = np.logical_or(dtIg, np.logical_and(
            dtm == 0, np.repeat(out_of_area.reshape(1, D), T, 0)))
        return {
            "image_id": imgId,
            "category_id": catId,
            "aRng": aRng,
            "maxDet": maxDet,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm,
            "gtMatches": gtm,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": gtIg,
            "dtIgnore": dtIg,
        }

    # ------------------------------------------------------------------
    def accumulate(self, p=None):
        if not self.evalImgs:
            raise RuntimeError("Please run evaluate() first")
        if p is None:
            p = self.params
        p.catIds = p.catIds if p.useCats == 1 else [-1]
        T = len(p.iouThrs)
        R = len(p.recThrs)
        K = len(p.catIds) if p.useCats else 1
        A = len(p.areaRng)
        M = len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        _pe = self._paramsEval
        catIds = _pe.catIds if _pe.useCats else [-1]
        setK = set(catIds)
        setA = set(map(tuple, _pe.areaRng))
        setM = set(_pe.maxDets)
        setI = set(_pe.imgIds)
        k_list = [n for n, k in enumerate(p.catIds) if k in setK]
        m_list = [m for n, m in enumerate(p.maxDets) if m in setM]
        a_list = [
            n for n, a in enumerate(map(lambda x: tuple(x), p.areaRng))
            if a in setA
        ]
        i_list = [n for n, i in enumerate(p.imgIds) if i in setI]
        I0 = len(_pe.imgIds)
        A0 = len(_pe.areaRng)
        for k, k0 in enumerate(k_list):
            Nk = k0 * A0 * I0
            for a, a0 in enumerate(a_list):
                Na = a0 * I0
                for m, maxDet in enumerate(m_list):
                    E = [self.evalImgs[Nk + Na + i] for i in i_list]
                    E = [e for e in E if e is not None]
                    if len(E) == 0:
                        continue
                    dtScores = np.concatenate(
                        [e["dtScores"][0:maxDet] for e in E]
                    )
                    inds = np.argsort(-dtScores, kind="mergesort")
                    dtScoresSorted = dtScores[inds]
                    dtm = np.concatenate(
                        [e["dtMatches"][:, 0:maxDet] for e in E], axis=1
                    )[:, inds]
                    dtIg = np.concatenate(
                        [e["dtIgnore"][:, 0:maxDet] for e in E], axis=1
                    )[:, inds]
                    gtIg = np.concatenate([e["gtIgnore"] for e in E])
                    npig = np.count_nonzero(gtIg == 0)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(
                        np.logical_not(dtm), np.logical_not(dtIg)
                    )
                    tp_sum = np.cumsum(tps, axis=1).astype(dtype=np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(dtype=np.float64)
                    for t, (tp, fp) in enumerate(zip(tp_sum, fp_sum)):
                        tp = np.array(tp)
                        fp = np.array(fp)
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        q = np.zeros((R,))
                        ss = np.zeros((R,))
                        if nd:
                            recall[t, k, a, m] = rc[-1]
                        else:
                            recall[t, k, a, m] = 0
                        pr = pr.tolist()
                        q = q.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds_r = np.searchsorted(rc, p.recThrs, side="left")
                        try:
                            for ri, pi in enumerate(inds_r):
                                q[ri] = pr[pi]
                                ss[ri] = dtScoresSorted[pi]
                        except IndexError:
                            pass
                        precision[t, :, k, a, m] = np.array(q)
                        scores[t, :, k, a, m] = np.array(ss)
        self.eval = {
            "params": p,
            "counts": [T, R, K, A, M],
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }

    # ------------------------------------------------------------------
    def summarize(self):
        def _summarize(ap=1, iouThr=None, areaRng="all", maxDets=100):
            p = self.params
            aind = [i for i, a in enumerate(p.areaRngLbl) if a == areaRng]
            mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
            if ap == 1:
                s = self.eval["precision"]
                if iouThr is not None:
                    t = np.where(iouThr == p.iouThrs)[0]
                    s = s[t]
                s = s[:, :, :, aind, mind]
            else:
                s = self.eval["recall"]
                if iouThr is not None:
                    t = np.where(iouThr == p.iouThrs)[0]
                    s = s[t]
                s = s[:, :, aind, mind]
            if len(s[s > -1]) == 0:
                return -1.0
            return float(np.mean(s[s > -1]))

        if self.params.iouType == "keypoints":
            # pycocotools summarizeKps (cocoeval.py:489-507)
            m = self.params.maxDets[0]
            self.stats = np.array([
                _summarize(1, maxDets=m),
                _summarize(1, iouThr=0.5, maxDets=m),
                _summarize(1, iouThr=0.75, maxDets=m),
                _summarize(1, areaRng="medium", maxDets=m),
                _summarize(1, areaRng="large", maxDets=m),
                _summarize(0, maxDets=m),
                _summarize(0, iouThr=0.5, maxDets=m),
                _summarize(0, iouThr=0.75, maxDets=m),
                _summarize(0, areaRng="medium", maxDets=m),
                _summarize(0, areaRng="large", maxDets=m),
            ])
            return self.stats

        stats = np.zeros((12,))
        stats[0] = _summarize(1)
        stats[1] = _summarize(1, iouThr=0.5, maxDets=self.params.maxDets[2])
        stats[2] = _summarize(1, iouThr=0.75, maxDets=self.params.maxDets[2])
        stats[3] = _summarize(1, areaRng="small", maxDets=self.params.maxDets[2])
        stats[4] = _summarize(1, areaRng="medium", maxDets=self.params.maxDets[2])
        stats[5] = _summarize(1, areaRng="large", maxDets=self.params.maxDets[2])
        stats[6] = _summarize(0, maxDets=self.params.maxDets[0])
        stats[7] = _summarize(0, maxDets=self.params.maxDets[1])
        stats[8] = _summarize(0, maxDets=self.params.maxDets[2])
        stats[9] = _summarize(0, areaRng="small", maxDets=self.params.maxDets[2])
        stats[10] = _summarize(0, areaRng="medium", maxDets=self.params.maxDets[2])
        stats[11] = _summarize(0, areaRng="large", maxDets=self.params.maxDets[2])
        self.stats = stats
        return stats


def _match_plain(ious: np.ndarray, gt_ignore: np.ndarray, iscrowd: np.ndarray,
                 iou_thrs: np.ndarray, dt_out_of_area: np.ndarray):
    """``_native.cocoeval_match`` in Python (its reference): for each
    threshold, each detection in score order takes the best still-free gt
    (a crowd gt stays free) at IoU >= the threshold, and stops at the
    ignored gts once it holds a real one. -> (dtm, gtm, dt_ignore) with
    1-based match indices (0 = unmatched)."""
    d_n, g_n = ious.shape
    t_n = len(iou_thrs)
    dtm = np.zeros((t_n, d_n), np.int64)
    gtm = np.zeros((t_n, g_n), np.int64)
    dti = np.zeros((t_n, d_n), np.uint8)
    for tind, t in enumerate(iou_thrs):
        for dind in range(d_n):
            iou = min([t, 1 - 1e-10])
            m = -1
            for gind in range(g_n):
                if gtm[tind, gind] > 0 and not iscrowd[gind]:
                    continue
                if m > -1 and gt_ignore[m] == 0 and gt_ignore[gind] == 1:
                    break
                if ious[dind, gind] < iou:
                    continue
                iou = ious[dind, gind]
                m = gind
            if m == -1:
                dti[tind, dind] = dt_out_of_area[dind]
                continue
            dti[tind, dind] = gt_ignore[m]
            dtm[tind, dind] = m + 1
            gtm[tind, m] = dind + 1
    return dtm, gtm, dti


def _bbox_iou_xywh(d: np.ndarray, g: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """bbIou from pycocotools maskApi.c: XYWH boxes, crowd uses dt area
    (the reference of ``_native.bbox_iou``)."""
    D, G = len(d), len(g)
    out = np.zeros((D, G))
    for gi in range(G):
        gx, gy, gw, gh = g[gi]
        ga = gw * gh
        for di in range(D):
            dx, dy, dw, dh = d[di]
            da = dw * dh
            w = min(dx + dw, gx + gw) - max(dx, gx)
            if w <= 0:
                continue
            h = min(dy + dh, gy + gh) - max(dy, gy)
            if h <= 0:
                continue
            i = w * h
            u = da if iscrowd[gi] else da + ga - i
            out[di, gi] = i / u
    return out


class PlainCOCOeval(COCOeval):
    """COCOeval on the numpy twins of the C++ functions: the reference the
    C++ path is held against (the tests, ``chip_smoke.py``), not a path of
    the port's evaluators."""
    mask_iou = staticmethod(rle_codec._iou_plain)
    box_iou = staticmethod(_bbox_iou_xywh)
    greedy_match = staticmethod(_match_plain)
