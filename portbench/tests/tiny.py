"""A tiny training cell for the CPU tests: the U2Seg configuration file with
narrow widths, 7 classes, small buckets and f32 products (the program and
the reference then agree to rounding), and the cell's traffic at small image
sizes. The pooler runs its plain twin (``pooler_impl: pallas`` on the CPU),
as the reference does."""
from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)

TINY = {
    "model.compute_dtype": "float32",
    "model.resnet.width_per_group": 8,
    "model.resnet.stem_out_channels": 16,
    "model.resnet.res2_out_channels": 32,
    "model.fpn.out_channels": 32,
    "model.roi_heads.pooler_impl": "pallas",
    "model.roi_heads.num_classes": 7,
    "model.roi_heads.batch_size_per_image": 32,
    "model.roi_heads.box_head.fc_dim": 64,
    "model.roi_heads.mask_head.conv_dim": 32,
    "model.rpn.pre_nms_topk_train": 64,
    "model.rpn.post_nms_topk_train": 64,
    "model.rpn.batch_size_per_image": 32,
    "model.sem_seg_head.num_classes": 5,
    "model.sem_seg_head.conv_dim": 32,
    "input.min_size_train": [64, 96],
    "input.max_size_train": 128,
    "input.pad_buckets": [[96, 128], [128, 96], [128, 128]],
    "datasets.train": ["u2seg_7_train_panoptic_separated"],
    "datasets.cluster_num": 7,
    "dataloader.num_workers": 2,
}


def tiny_cell(tmp: str, workload: str = "u2seg800-train"):
    """(configuration file, traffic) of the tiny cell, written under ``tmp``."""
    import yaml

    with open(os.path.join(PORTBENCH, "configs", "u2seg-r50-800.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(TINY)
    path = os.path.join(tmp, "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    with open(os.path.join(PORTBENCH, "workloads", workload + ".json")) as f:
        tr = json.load(f)
    data = tr["data"]
    data["images"] = {"long_side": 96, "short_sides": [64, 80]}
    data["num_things"], data["num_stuff"] = 7, 4
    data["instances"].update(max=6, mean=3)
    for key in ("instances", "sem_seg"):
        data["paths"][key] = data["paths"][key].replace("800_clusters", "7_clusters")
    tr["trace_steps"] = 2
    return path, tr
