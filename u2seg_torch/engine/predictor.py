"""Inference APIs: the single-image predictor, its batched, pipelined
form, and the dataset evaluation driver (counterpart of
``u2seg_tpu/engine/predictor.py``).

``DefaultPredictor`` takes raw images, resizes the shortest edge to the test
size, pads to a bucket, runs the model and returns original-resolution
outputs. ``detections_to_records`` turns fixed-capacity ``Detections`` into
original-resolution COCO-style records on the host.
``run_panoptic_evaluation`` scores registered datasets with U2Seg's
cluster-matching protocol (AP, mIoU, PQ).

The predictor and the driver run on ``cuda`` unless the caller names a
device (or hands in a model that already lives on one); with no GPU and no
device they raise.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from u2seg_torch.config import Config


def detections_to_records(
    boxes: np.ndarray,          # (K, 4) XYXY network-input coords
    scores: np.ndarray,
    classes: np.ndarray,
    valid: np.ndarray,
    mask_logits: Optional[np.ndarray],   # (K, M, M)
    input_hw: Tuple[int, int],
    orig_hw: Tuple[int, int],
    mask_threshold: float = 0.5,
) -> dict:
    """Rescale to the original resolution and paste masks (exact host path:
    per-box bilinear resampling)."""
    from u2seg_torch.engine.panoptic_render import paste_mask_exact
    from u2seg_torch.evaluation import rle as rle_codec

    ih, iw = input_hw
    oh, ow = orig_hw
    sel = np.asarray(valid).astype(bool)
    b = np.asarray(boxes)[sel].astype(np.float64)
    scale_x, scale_y = ow / iw, oh / ih
    b[:, 0::2] *= scale_x
    b[:, 1::2] *= scale_y
    b[:, 0::2] = b[:, 0::2].clip(0, ow)
    b[:, 1::2] = b[:, 1::2].clip(0, oh)
    out = {
        "boxes": b,
        "scores": np.asarray(scores)[sel],
        "classes": np.asarray(classes)[sel],
    }
    if mask_logits is not None:
        rles = []
        full_masks = []
        ml = np.asarray(mask_logits, np.float32)[sel]
        for i in range(len(b)):
            prob = 1.0 / (1.0 + np.exp(-ml[i]))
            ys, xs, sub = paste_mask_exact(prob, b[i], oh, ow)
            canvas = np.zeros((oh, ow), np.uint8)
            canvas[ys, xs] = sub >= mask_threshold
            r = rle_codec.encode(canvas)
            r["counts"] = r["counts"].decode("ascii")
            rles.append(r)
            full_masks.append(canvas)
        out["rles"] = rles
        out["masks"] = full_masks
    return out


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy() if x.is_floating_point() \
        else x.detach().cpu().numpy()


class DefaultPredictor:
    """Single-image panoptic predictor.

    Takes a raw BGR or RGB uint8 image, resizes the shortest edge to the
    test size, pads to a bucket, runs the model, and returns
    original-resolution outputs. Without a ``model`` it builds one and
    loads ``cfg.model.weights`` into it (when set).
    """

    def __init__(self, cfg: Config, model=None,
                 device: Optional[Union[str, torch.device]] = None):
        from u2seg_torch.data import transforms as T
        from u2seg_torch.models.build import build_model

        name = cfg.model.meta_architecture
        if name != "PanopticFPN":
            # the JAX predictor's forward passes combine=False, which only
            # PanopticFPN takes, and renders panoptic outputs
            raise ValueError(
                f"meta architecture {name!r} does not run through the predictor: "
                "only PanopticFPN does, as in the JAX package")
        self.cfg = cfg
        if model is None:
            model = build_model(cfg, device=device)
            if cfg.model.weights:
                from u2seg_torch.engine.checkpoint import load_model_weights

                load_model_weights(model, cfg.model.weights)
        elif device is not None:
            model = model.to(torch.device(device))
        self.model = model.eval()
        self.device = next(self.model.parameters()).device
        # accounting for the batched drain: number of device-to-host
        # transfers and fetched bytes
        self.fetch_stats = {"fetches": 0, "bytes": 0}
        self.aug = T.ResizeShortestEdge(
            (cfg.input.min_size_test,), cfg.input.max_size_test
        )
        self.input_format = cfg.model.input_format
        self.buckets = tuple(cfg.input.pad_buckets)

    @classmethod
    def from_jax(cls, cfg: Config, params, batch_stats,
                 device: Optional[Union[str, torch.device]] = None):
        """A predictor on the JAX package's variable trees (nested dicts of
        arrays), converted by ``weights.from_jax``."""
        from u2seg_torch.models.build import resolve_device
        from u2seg_torch.models.panoptic_fpn import PanopticFPN
        from u2seg_torch.weights import from_jax

        dev = resolve_device(device)
        model = PanopticFPN(cfg.model)
        model.load_state_dict(from_jax(params, batch_stats))
        return cls(cfg, model=model.to(dev))

    # -- the three device programs ------------------------------------------

    def _fwd(self, image: torch.Tensor, size: torch.Tensor):
        # fusion happens at full resolution (host or device render), so no
        # stride-4 combine here
        return self.model(image, size, combine=False)

    def _render_tail(self, out, size: torch.Tensor, orig_size: torch.Tensor):
        from u2seg_torch.engine.device_render import (
            pack_fetch_buffer, pack_rendered_batch, render_batch,
        )
        cfg = self.cfg
        pano = cfg.model.panoptic
        bsz = size.shape[0]
        rendered = pack_rendered_batch(render_batch(
            out.detections, out.sem_seg_logits, size, orig_size,
            canvas=tuple(cfg.test.render_canvas),
            k_fuse=cfg.test.render_k_fuse,
            max_runs=cfg.test.render_max_runs,
            instance_conf_thresh=pano.instance_conf_thresh,
            overlap_thresh=pano.overlap_thresh,
            stuff_area_limit=pano.stuff_area_limit,
        ), prefix=bsz * cfg.test.fetch_runs_per_image)
        det = out.detections
        small_det = {
            "boxes": det.boxes, "scores": det.scores,
            "classes": det.classes, "valid": det.valid,
        }
        # everything the host needs in the common case rides ONE contiguous
        # buffer = ONE device-to-host copy
        buf = pack_fetch_buffer(rendered, small_det)
        # the full run buffers and the logits stay on the device for the
        # rare fallbacks; they are copied only when touched
        return buf, rendered, det.mask_logits, out.sem_seg_logits

    @torch.no_grad()
    def _fwd_render(self, image, size, orig_size):
        """Forward + exact full-res render on the device; the host fetches
        RLE maps and segment tables (engine/device_render.py)."""
        return self._render_tail(self._fwd(image, size), size, orig_size)

    @torch.no_grad()
    def _fwd_render_raw(self, raw, orig_size, size, bucket):
        """As ``_fwd_render`` on raw uint8 images: the test-time resize into
        the ``bucket`` (network-input pad bucket) happens on the device."""
        from u2seg_torch.engine.device_render import resize_image_device

        resized = torch.stack([
            resize_image_device(raw[i], orig_size[i], size[i], bucket)
            for i in range(raw.shape[0])])
        return self._render_tail(self._fwd(resized, size), size, orig_size)

    # -- host side ------------------------------------------------------------

    def _channels(self, original_image: np.ndarray) -> np.ndarray:
        if self.input_format == "RGB" and original_image.shape[-1] == 3:
            return original_image
        return original_image[:, :, ::-1]

    def _prepare(self, original_image: np.ndarray):
        """Raw image -> (bucket-padded f32 input, (h, w), (oh, ow)).

        The test-time resize is FLOAT bilinear (half-pixel centers, border
        replicate): resizing in f32 makes this host path and the on-device
        resize (device_render.resize_image_device) agree to f32 rounding,
        where a uint8 resize would quantize."""
        from u2seg_torch.data import transforms as T

        image = self._channels(original_image)
        oh, ow = image.shape[:2]
        rng = np.random.RandomState(0)
        tfm = self.aug.get_transform(image, rng)
        image = tfm.apply_image(image.astype(np.float32))
        h, w = image.shape[:2]
        bh, bw = T.pick_bucket(h, w, self.buckets)
        if h > bh or w > bw:
            s = min(bh / h, bw / w)
            rescale = T.ResizeTransform(h, w, int(h * s), int(w * s))
            image = rescale.apply_image(image)
            h, w = image.shape[:2]
        padded = np.zeros((bh, bw, 3), np.float32)
        padded[:h, :w] = image
        return padded, (h, w), (oh, ow)

    def _prepare_raw(self, original_image: np.ndarray):
        """Raw image -> (raw-bucket-padded u8, (ih, iw), (oh, ow), bucket)
        for the device-resize path, or None if no raw bucket fits (the
        caller then uses the host-resize path for this image)."""
        from u2seg_torch.data import transforms as T

        image = self._channels(original_image)
        oh, ow = image.shape[:2]
        raw_buckets = tuple(self.cfg.test.raw_buckets)
        if not any(bh >= oh and bw >= ow for bh, bw in raw_buckets):
            return None
        size = self.cfg.input.min_size_test
        ih, iw = T.ResizeShortestEdge.get_output_shape(
            oh, ow, size, self.cfg.input.max_size_test)
        bh, bw = T.pick_bucket(ih, iw, self.buckets)
        if ih > bh or iw > bw:  # shrink-to-bucket (host path does the same)
            s = min(bh / ih, bw / iw)
            ih, iw = int(ih * s), int(iw * s)
        rh, rw = T.pick_bucket(oh, ow, raw_buckets)
        padded = np.zeros((rh, rw, 3), np.uint8)
        padded[:oh, :ow] = image
        return padded, (ih, iw), (oh, ow), (bh, bw)

    def _post(self, det_np: dict, sem_logits_np: Optional[np.ndarray],
              input_hw: Tuple[int, int], orig_hw: Tuple[int, int]) -> dict:
        """Host-side per-image postprocess on already-fetched arrays."""
        records = detections_to_records(
            det_np["boxes"], det_np["scores"], det_np["classes"],
            det_np["valid"], det_np.get("mask_logits"), input_hw, orig_hw,
        )
        result = {"instances": records}
        if sem_logits_np is None:
            return result
        # exact full-resolution semantic + panoptic render
        from u2seg_torch.engine.panoptic_render import render_panoptic_output

        pano_cfg = self.cfg.model.panoptic
        sem, pan, segments = render_panoptic_output(
            det_np["boxes"], det_np["scores"], det_np["classes"],
            det_np["valid"], det_np.get("mask_logits"), sem_logits_np,
            input_hw, orig_hw,
            instance_conf_thresh=pano_cfg.instance_conf_thresh,
            overlap_thresh=pano_cfg.overlap_thresh,
            stuff_area_limit=pano_cfg.stuff_area_limit,
        )
        result["sem_seg"] = sem
        result["panoptic"] = pan
        result["segments"] = segments
        return result

    @staticmethod
    def _fetch_image(out, i: int):
        """Slice image ``i`` of a model output to host numpy."""
        det = out.detections
        det_np = {
            "boxes": _to_numpy(det.boxes[i]),
            "scores": _to_numpy(det.scores[i]),
            "classes": _to_numpy(det.classes[i]),
            "valid": _to_numpy(det.valid[i]),
        }
        if det.mask_logits is not None:
            det_np["mask_logits"] = _to_numpy(det.mask_logits[i])
        sem = (_to_numpy(out.sem_seg_logits[i])
               if getattr(out, "sem_seg_logits", None) is not None else None)
        return det_np, sem

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    def __call__(self, original_image: np.ndarray) -> dict:
        padded, hw, ohow = self._prepare(original_image)
        out = self._fwd(self._upload(padded[None]),
                        self._upload(np.array([list(hw)], np.int32)))
        det_np, sem_np = self._fetch_image(out, 0)
        return self._post(det_np, sem_np, hw, ohow)

    def _drain_rendered(self, group, n_real, out):
        """Decode one in-flight device-rendered batch.

        ONE device-to-host copy covers the common case: every host-needed
        field (per-image tables, run offsets, AND a fixed prefix of the
        batch-compacted RLE buffers, sized by
        ``cfg.test.fetch_runs_per_image``) was flattened on the device into
        a single contiguous uint8 buffer (device_render.pack_fetch_buffer).
        Only a batch whose total run count overflows the prefix pays two
        more copies (a slice of the full buffers at a power-of-two
        length)."""
        from u2seg_torch.engine.device_render import (
            decode_rendered_image, fetch_layout, unpack_fetch_buffer,
        )

        buf, rendered, mask_logits, sem_logits = out
        bsz, k_fuse = rendered.takes.shape
        layout = fetch_layout(
            bsz, k_det=self.cfg.model.roi_heads.detections_per_image,
            k_fuse=k_fuse, num_stuff=rendered.stuff_ok.shape[1],
            prefix=rendered.starts_prefix.shape[0],
        )
        host = buf.cpu().numpy()
        self.fetch_stats["fetches"] += 1
        self.fetch_stats["bytes"] += int(host.size)
        rend = unpack_fetch_buffer(host, layout)
        offs = rend["offs"].astype(np.int64)
        total = int(offs[-1])
        self.fetch_stats["runs"] = self.fetch_stats.get("runs", 0) + total
        self.fetch_stats["runs_max_batch"] = max(
            self.fetch_stats.get("runs_max_batch", 0), total)
        starts_c, values_c = rend["starts"], rend["values"]
        if total > len(starts_c):
            cap = rendered.starts.shape[0]
            cut = 4096
            while cut < total:
                cut *= 2
            cut = min(cut, cap)
            starts_c = rendered.starts[:cut].cpu().numpy()
            values_c = rendered.values[:cut].cpu().numpy()
            self.fetch_stats["fetches"] += 2
            self.fetch_stats["bytes"] += 6 * cut
        canvas = tuple(self.cfg.test.render_canvas)
        for i in range(n_real):
            meta, _, hw, ohow = group[i]
            det_i = {
                "boxes": rend["det_boxes"][i],
                "scores": rend["det_scores"][i],
                "classes": rend["det_classes"][i],
                "valid": rend["det_valid"][i].astype(bool),
            }
            if bool(rend["fallback"][i]):
                # exact host re-render (image exceeds the canvas / run or
                # fusion budget); logits are fetched only here
                if mask_logits is not None:
                    det_i["mask_logits"] = _to_numpy(mask_logits[i])
                sem_np = _to_numpy(sem_logits[i])
                self.fetch_stats["fetches"] += 2
                self.fetch_stats["fallbacks"] = self.fetch_stats.get(
                    "fallbacks", 0) + 1
                yield meta, self._post(det_i, sem_np, tuple(hw), ohow)
                continue
            records = detections_to_records(
                det_i["boxes"], det_i["scores"], det_i["classes"],
                det_i["valid"], None, tuple(hw), ohow,
            )
            p0, p1, p2 = offs[2 * i], offs[2 * i + 1], offs[2 * i + 2]
            r = {
                "takes": rend["takes"][i].astype(bool),
                "order": rend["order"][i],
                "sorted_scores": rend["sorted_scores"][i],
                "sorted_classes": rend["sorted_classes"][i],
                "stuff_ok": rend["stuff_ok"][i].astype(bool),
                "stuff_area": rend["stuff_area"][i],
                "pan_starts": starts_c[p0:p1],
                "pan_values": values_c[p0:p1],
                "pan_nruns": p1 - p0,
                "sem_starts": starts_c[p1:p2],
                "sem_values": values_c[p1:p2],
                "sem_nruns": p2 - p1,
                "det_valid": det_i["valid"],
            }
            sem, pan, segments = decode_rendered_image(r, canvas, ohow)
            yield meta, {
                "instances": records, "sem_seg": sem,
                "panoptic": pan, "segments": segments,
            }

    def run_batched(self, examples, batch_size: int = 4,
                    device_render: bool = False,
                    device_resize: bool = False):
        """Batched inference over ``(meta, image)`` pairs.

        Same-bucket images are grouped into device batches, and up to
        ``DEPTH`` batches are in flight: batch ``i+1`` is enqueued before
        batch ``i``'s outputs are fetched.

        Yields ``(meta, result_dict)`` in same-bucket-grouped order, with
        the per-image results of ``__call__``. Partial tail groups are
        padded by repeating the last image.

        The device-to-host fetch and the host-side decode of each in-flight
        batch run on worker threads. All device work, the copies included,
        goes to one CUDA stream in the order it is enqueued: a worker's copy
        waits for its own batch and for whatever the main thread enqueued
        before the worker asked for the copy. In practice the stages do not
        overlap: the main thread's prepare, the forward's ~2900 kernel
        launches and the render's enqueue hold it for nearly all of a
        batch's time, so the workers find nothing to run beside it, and the
        pipelined throughput equals the serial sum of the stages (measured
        on an H100 in every mode; ``PERF.md`` section 5).
        """
        from collections import defaultdict, deque
        from concurrent.futures import ThreadPoolExecutor

        DEPTH = 3  # batches in flight (device queue + one being decoded)
        buffers: Dict[tuple, list] = defaultdict(list)
        pending: deque = deque()
        pool = ThreadPoolExecutor(max_workers=2)

        def fetch_host(group, n_real, out):
            results = []
            for i in range(n_real):
                meta, _, hw, ohow = group[i]
                det_np, sem_np = self._fetch_image(out, i)
                results.append(
                    (meta, self._post(det_np, sem_np, tuple(hw), ohow)))
            return results

        def dispatch(key, group, n_real):
            stack = self._upload(np.stack([g[1] for g in group]))
            sizes = self._upload(np.array([g[2] for g in group], np.int32))
            if key[0] == "raw":
                osizes = self._upload(
                    np.array([g[3] for g in group], np.int32))
                out = self._fwd_render_raw(stack, osizes, sizes, key[2])
                fut = pool.submit(
                    lambda: list(self._drain_rendered(group, n_real, out)))
            elif device_render:
                osizes = self._upload(
                    np.array([g[3] for g in group], np.int32))
                out = self._fwd_render(stack, sizes, osizes)
                fut = pool.submit(
                    lambda: list(self._drain_rendered(group, n_real, out)))
            else:
                out = self._fwd(stack, sizes)
                fut = pool.submit(fetch_host, group, n_real, out)
            pending.append(fut)

        try:
            for meta, image in examples:
                prepared = None
                if device_render and device_resize:
                    prepared = self._prepare_raw(image)
                if prepared is not None:
                    padded, hw, ohow, bucket = prepared
                    key = ("raw", padded.shape[:2], bucket)
                    entry = (meta, padded, hw, ohow)
                else:
                    padded, hw, ohow = self._prepare(image)
                    key = ("host", padded.shape[:2])
                    entry = (meta, padded, hw, ohow)
                buf = buffers[key]
                buf.append(entry)
                if len(buf) == batch_size:
                    dispatch(key, buf, batch_size)
                    buffers[key] = []
                    while len(pending) > DEPTH - 1:
                        yield from pending.popleft().result()
            for key, buf in buffers.items():
                if not buf:
                    continue
                n_real = len(buf)
                while len(buf) < batch_size:
                    buf.append(buf[-1])
                dispatch(key, buf, n_real)
            while pending:
                yield from pending.popleft().result()
        finally:
            # cancel queued work so a consumer abandoning the generator
            # mid-stream doesn't leave detached futures whose exceptions
            # would be silently dropped
            pool.shutdown(wait=False, cancel_futures=True)


def build_u2seg_evaluators(cfg: Config, meta, eval_mode: str,
                           matching_dir: str = "./hungarian_matching"):
    """Evaluator stack of the U2Seg protocol: semantic mIoU, instance AP and
    panoptic PQ, each wired to the cluster-matching mode. The order matters:
    ``DatasetEvaluators.evaluate`` runs them in list order, and in ``auto``
    mode the panoptic evaluator reads the mappings the first two wrote."""
    from u2seg_torch.data.builtin_meta import (
        NUM_SUPERCATEGORIES, thing_dataset_id_to_contiguous_id,
    )
    from u2seg_torch.evaluation.coco_api import COCO
    from u2seg_torch.evaluation.coco_evaluator import COCOEvaluator
    from u2seg_torch.evaluation.evaluator import DatasetEvaluators
    from u2seg_torch.evaluation.panoptic_evaluator import COCOPanopticEvaluator
    from u2seg_torch.evaluation.sem_seg_evaluator import SemSegEvaluator

    cluster_num = cfg.datasets.cluster_num
    coco_gt = COCO(meta.json_file)
    evals = [
        SemSegEvaluator(
            mode=eval_mode,
            num_pred_classes=cfg.model.sem_seg_head.num_classes,
            matching_dir=matching_dir,
        ),
        COCOEvaluator(
            coco_gt, mode=eval_mode, num_clusters=cluster_num,
            matching_dir=matching_dir,
            tasks=("bbox",),   # segm skipped in the protocol (ref :353-354)
        ),
    ]
    pan_json = meta.get("panoptic_json")
    if pan_json and os.path.exists(pan_json):
        thing_c2d = {
            v: k for k, v in thing_dataset_id_to_contiguous_id().items()
        }
        categories = {}
        for did in thing_c2d.values():
            categories[did] = {"id": did, "isthing": 1}
        for s in range(1, NUM_SUPERCATEGORIES + 1):
            categories[cluster_num + s] = {
                "id": cluster_num + s, "isthing": 0,
            }
        # supervised=...: the JAX package passes the mode alone, and its
        # panoptic evaluator then looks for cluster mappings that a
        # supervised run never writes (FileNotFoundError)
        evals.append(COCOPanopticEvaluator(
            categories, thing_c2d, cluster_num=cluster_num,
            matching_dir=matching_dir,
            mode="eval" if eval_mode in ("eval", "auto") else eval_mode,
            supervised=eval_mode == "supervised",
        ))
    return DatasetEvaluators(evals), pan_json


def run_panoptic_evaluation(cfg: Config, eval_mode: str = "auto",
                            device: Optional[Union[str, torch.device]] = None,
                            matching_dir: str = "./hungarian_matching") -> dict:
    """Dataset evaluation driver: registry -> sampler -> threaded image and
    GT reads -> ``DefaultPredictor.run_batched`` -> {SemSeg, COCO, Panoptic}
    evaluators, per dataset of ``cfg.datasets.test`` (the eval-only path of
    tools/train_net.py).

    ``eval_mode`` is "hungarian_matching" (pass 1: writes the mappings into
    ``matching_dir``), "eval" (pass 2: reads them), "auto" (both in one run)
    or "supervised". Each dataset gets its own ``DefaultPredictor(cfg,
    device=device)``.

    Each process of a ``torch.distributed`` group takes its
    ``InferenceSampler`` shard and scores it alone: nothing gathers the
    shards, as in the JAX package (detectron2 gathers them)."""
    import json as jsonlib
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from u2seg_torch.data.builtin import register_all_coco
    from u2seg_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from u2seg_torch.data.image_io import read_image, read_panoptic_png, read_sem_seg
    from u2seg_torch.data.loader import InferenceSampler
    from u2seg_torch.models.build import resolve_device
    from u2seg_torch.parallel import comm

    device = resolve_device(device)        # raises with no GPU and no device
    register_all_coco(cfg.datasets.root, cluster_num=cfg.datasets.cluster_num)
    results = {}
    for dataset_name in cfg.datasets.test:
        dicts = DatasetCatalog.get(dataset_name)
        meta = MetadataCatalog.get(dataset_name)
        evaluator, pan_json = build_u2seg_evaluators(
            cfg, meta, eval_mode, matching_dir)
        pan_gt_by_image = {}
        if pan_json and os.path.exists(pan_json):
            with open(pan_json) as f:
                pj = jsonlib.load(f)
            pan_gt_by_image = {
                a["image_id"]: a for a in pj.get("annotations", [])
            }
        pred = DefaultPredictor(cfg, device=device)
        evaluator.reset()
        sampler = InferenceSampler(
            len(dicts), comm.get_rank(), comm.get_world_size())

        def load_example(idx):
            """Image + per-image GT reads (threaded: IO releases the GIL)."""
            d = dicts[idx]
            img = read_image(d["file_name"], cfg.model.input_format)
            inp = {"image_id": d["image_id"]}
            if "sem_seg_file_name" in d:
                inp["sem_seg_gt"] = read_sem_seg(d["sem_seg_file_name"]).astype(np.int64)
            gt_ann = pan_gt_by_image.get(d["image_id"])
            if gt_ann is not None:
                pan_root = meta.get("panoptic_root", "")
                inp["pan_gt"] = read_panoptic_png(
                    os.path.join(pan_root, gt_ann["file_name"]))
                inp["gt_segments"] = gt_ann["segments_info"]
            return inp, img

        def examples():
            workers = max(cfg.dataloader.num_workers, 1)
            with ThreadPoolExecutor(max_workers=workers) as pool:
                futs = deque()
                for idx in sampler:
                    futs.append(pool.submit(load_example, idx))
                    if len(futs) >= 2 * workers:
                        yield futs.popleft().result()
                while futs:
                    yield futs.popleft().result()

        stream = pred.run_batched(
            examples(), batch_size=cfg.test.ims_per_batch,
            device_render=cfg.test.device_render,
            device_resize=cfg.test.device_resize)
        for inp, out in stream:
            out_rec = {
                "instances": out["instances"],
                "sem_seg": out.get("sem_seg"),
            }
            if "panoptic" in out:
                out_rec["panoptic"] = out["panoptic"]
                out_rec["segments"] = out["segments"]
            evaluator.process([inp], [out_rec])
        results[dataset_name] = evaluator.evaluate()
    return results
