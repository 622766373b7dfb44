"""Pseudo-label generation: DINO crop features -> clustering -> COCO jsons
(counterpart of ``tools/generate_pseudo_labels.py``).

    python -m u2seg_torch.tools.generate_pseudo_labels --stage all \\
        --crops-dir datasets/cutler_crops --dino-weights dino_vitbase16_pretrain.pth \\
        --instances-json datasets/cutler_instances.json --stego-dir datasets/stego_maps \\
        [--device cpu] [--num-clusters 800] [--select-json selected.json]

Stages (``--stage``; "all" runs 1-4, as the JAX script):
  1 cluster:   embed the masked instance crops of ``--crops-dir`` (one image
               file per instance, named "{image_id}_{ann_id}") with DINO
               ViT-B/16 (key facet, mean over patches), kNN density and
               k-means(++) on the device, write ``--decode-json`` (and the
               USL regularised selection to ``--select-json`` when given)
  2 assign:    cluster ids onto the class-agnostic instance json
  3 panoptic:  cluster instances + STEGO maps -> panoptic PNGs and json
  4 stuff:     panoptic PNGs -> semantic training PNGs
  5 supergt:   GT panoptic json -> the {N}super evaluation json

The flags and defaults are the JAX script's, with one more: ``--device``
(``cuda`` by default; ``cpu`` only when asked). Crops are read with
``data.image_io.read_image`` and resized with ``data.transforms.
resize_bilinear_u8`` (OpenCV's INTER_LINEAR, bit for bit). Without
``--dino-weights`` the ViT draws seeded random weights (smoke mode).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from collections import defaultdict
from typing import List, Optional

import numpy as np
import torch

logger = logging.getLogger("pseudo_labels")

STAGES = ["cluster", "assign", "panoptic", "stuff", "supergt"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def embed_crops(model, files: List[str], crop_size: int, batch_size: int,
                dev: torch.device):
    """DINO features (N, D) on ``dev`` of the crop files, ``batch_size`` at a
    time, and the host seconds spent reading and resizing them."""
    from u2seg_torch.data.image_io import read_image
    from u2seg_torch.data.transforms import resize_bilinear_u8
    from u2seg_torch.pseudo.dino import IMAGENET_MEAN, IMAGENET_STD, masked_crop_features

    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev).view(1, 3, 1, 1)
    feats, read_s = [], 0.0
    with torch.no_grad():
        for s in range(0, len(files), batch_size):
            t0 = time.perf_counter()
            batch = np.stack([resize_bilinear_u8(read_image(f, "RGB"), crop_size, crop_size)
                              for f in files[s:s + batch_size]])
            read_s += time.perf_counter() - t0
            x = torch.from_numpy(batch).to(dev).permute(0, 3, 1, 2).float()
            feats.append(masked_crop_features(model, (x / 255.0 - mean) / std))
    return torch.cat(feats), read_s


def stage_cluster(args) -> dict:
    from u2seg_torch.engine.checkpoint import load_reference_state_dict
    from u2seg_torch.pseudo.dino import DinoViT, load_dino_state_dict, seeded_dino_state
    from u2seg_torch.pseudo.kmeans import (
        density_from_knn, kmeans, knn, select_representatives_regularized,
    )

    dev = torch.device(args.device)
    t_start = time.perf_counter()
    model = DinoViT(facet="k", img_size=args.crop_size)
    grid = args.crop_size // model.patch_size
    if args.dino_weights:
        load_dino_state_dict(model, load_reference_state_dict(args.dino_weights),
                             grid_hw=(grid, grid))
    else:
        logger.warning("no --dino-weights: using random features (smoke mode)")
        seeded_dino_state(model, seed=0)
    model.to(dev).eval()

    names = sorted(os.listdir(args.crops_dir))
    if not names:
        raise ValueError(f"no crops in {args.crops_dir}")
    keys = [os.path.splitext(f)[0] for f in names]
    t0 = time.perf_counter()
    feats, read_s = embed_crops(model, [os.path.join(args.crops_dir, f) for f in names],
                                args.crop_size, args.batch_size, dev)
    _sync(dev)
    t1 = time.perf_counter()
    logger.info("embedded %d crops", len(feats))

    dists, _ = knn(feats, k=min(args.knn, max(len(feats) - 1, 1)))
    density = density_from_knn(dists)
    _sync(dev)
    t2 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(args.seed)
    _, assignments = kmeans(feats, args.num_clusters, num_iters=args.kmeans_iters,
                            generator=g)
    assignments = assignments.cpu().numpy()
    t3 = time.perf_counter()
    decode = {k: int(a) for k, a in zip(keys, assignments)}
    os.makedirs(os.path.dirname(args.decode_json) or ".", exist_ok=True)
    with open(args.decode_json, "w") as fp:
        json.dump(decode, fp)
    logger.info("wrote %s (%d entries)", args.decode_json, len(decode))

    if args.select_json:
        # USL regularised representative selection (ref usl-imagenet.py
        # :139-153 with the ImageNet_usl_dino_0.2.yaml REG settings)
        nd = np.maximum(density.cpu().numpy().astype(np.float64), 1e-12)
        sel = select_representatives_regularized(
            feats, assignments, nd, args.num_clusters, iters=args.reg_iters,
            w=args.reg_w, momentum=args.reg_momentum, horizon_num=args.reg_horizon,
            exclude_same_cluster=True)
        with open(args.select_json, "w") as fp:
            json.dump({"selected_keys": [keys[i] for i in sel],
                       "selected_indices": sel.tolist()}, fp)
        logger.info("wrote %s (%d selected)", args.select_json, len(sel))
    t4 = time.perf_counter()
    return {"crops": len(keys), "setup_s": t0 - t_start, "embed_s": t1 - t0,
            "read_s": read_s, "knn_s": t2 - t1, "kmeans_s": t3 - t2, "select_s": t4 - t3}


def stage_assign(args) -> dict:
    from u2seg_torch.pseudo.assembly import assign_cluster_ids

    with open(args.instances_json) as f:
        src = json.load(f)
    with open(args.decode_json) as f:
        decode = json.load(f)
    out = assign_cluster_ids(src, decode, args.num_clusters)
    with open(args.output_json, "w") as f:
        json.dump(out, f)
    logger.info("wrote %s (%d anns)", args.output_json, len(out["annotations"]))
    return {"annotations": len(out["annotations"])}


def stage_panoptic(args) -> dict:
    from u2seg_torch.data.builtin_meta import create_cate
    from u2seg_torch.pseudo.assembly import merge_instances_and_stego, write_panoptic_png

    with open(args.output_json) as f:
        inst = json.load(f)
    by_image = defaultdict(list)
    for ann in inst["annotations"]:
        by_image[ann["image_id"]].append(ann)
    os.makedirs(args.panoptic_dir, exist_ok=True)
    pan_anns = []
    for img in inst["images"]:
        stem = os.path.splitext(img["file_name"])[0]
        stego_path = os.path.join(args.stego_dir, stem + ".npy")
        hw = (img["height"], img["width"])
        stego = np.load(stego_path) if os.path.exists(stego_path) else np.zeros(hw, np.int64)
        pan, segs = merge_instances_and_stego(by_image.get(img["id"], []), stego,
                                              args.num_clusters, hw)
        write_panoptic_png(pan, os.path.join(args.panoptic_dir, stem + ".png"))
        pan_anns.append({"image_id": img["id"], "file_name": stem + ".png",
                         "segments_info": segs})
    out = {"images": inst["images"], "annotations": pan_anns,
           "categories": create_cate(args.num_clusters)}
    with open(args.panoptic_json, "w") as f:
        json.dump(out, f)
    logger.info("wrote %s + %d pngs", args.panoptic_json, len(pan_anns))
    return {"images": len(pan_anns)}


def stage_stuff(args) -> dict:
    from u2seg_torch.data.image_io import write_png
    from u2seg_torch.pseudo.assembly import panoptic_to_semantic, read_panoptic_png

    with open(args.panoptic_json) as f:
        pj = json.load(f)
    os.makedirs(args.stuff_dir, exist_ok=True)
    for ann in pj["annotations"]:
        pan = read_panoptic_png(os.path.join(args.panoptic_dir, ann["file_name"]))
        sem = panoptic_to_semantic(pan, ann["segments_info"], stuff_base=args.num_clusters)
        write_png(os.path.join(args.stuff_dir, ann["file_name"]), sem)
    logger.info("wrote %d stuff pngs", len(pj["annotations"]))
    return {"images": len(pj["annotations"])}


def stage_supergt(args) -> dict:
    from u2seg_torch.pseudo.assembly import gt_panoptic_to_supercategories

    with open(args.gt_panoptic_json) as f:
        pj = json.load(f)
    out = gt_panoptic_to_supercategories(pj, args.num_clusters)
    with open(args.super_json, "w") as f:
        json.dump(out, f)
    logger.info("wrote %s", args.super_json)
    return {"annotations": len(out.get("annotations", []))}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="u2seg_torch pseudo-label generation")
    p.add_argument("--stage", default="all", choices=["all"] + STAGES)
    p.add_argument("--num-clusters", type=int, default=800)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # stage 1
    p.add_argument("--crops-dir", default="datasets/cutler_crops")
    p.add_argument("--dino-weights", default="")
    p.add_argument("--crop-size", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--knn", type=int, default=20)
    p.add_argument("--kmeans-iters", type=int, default=100)
    p.add_argument("--decode-json", default="cluster_labels_decode.json")
    p.add_argument("--select-json", default="",
                   help="optional USL selected-representatives output")
    p.add_argument("--reg-iters", type=int, default=2)
    p.add_argument("--reg-w", type=float, default=0.05)
    p.add_argument("--reg-momentum", type=float, default=0.0)
    p.add_argument("--reg-horizon", type=int, default=32)
    # stage 2
    p.add_argument("--instances-json", default="datasets/cutler_instances.json")
    p.add_argument("--output-json", default="cluster_curated.json")
    # stage 3
    p.add_argument("--stego-dir", default="datasets/stego_maps")
    p.add_argument("--panoptic-dir", default="panoptic_ours")
    p.add_argument("--panoptic-json", default="panoptic_coco.json")
    # stage 4
    p.add_argument("--stuff-dir", default="panoptic_stuff_ours")
    # stage 5
    p.add_argument("--gt-panoptic-json",
                   default="datasets/coco/annotations/panoptic_val2017.json")
    p.add_argument("--super-json", default="panoptic_val2017_super.json")
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    """Parse ``argv`` (default: the command line) and run the stages; returns
    {stage: what it counted, its wall seconds ``s`` and, for ``cluster``, the
    seconds of its parts}."""
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    logging.basicConfig(level=logging.INFO)
    stages = STAGES[:4] if args.stage == "all" else [args.stage]
    stage_fns = {"cluster": stage_cluster, "assign": stage_assign,
                 "panoptic": stage_panoptic, "stuff": stage_stuff, "supergt": stage_supergt}
    out = {}
    for s in stages:
        t0 = time.perf_counter()
        out[s] = stage_fns[s](args)
        out[s]["s"] = time.perf_counter() - t0
    return out


if __name__ == "__main__":
    main()
