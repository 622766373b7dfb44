"""A tiny ViTDet training cell for the CPU tests: the ViTDet-L configuration
file with narrow widths (dim 32, 3 blocks, the last global, windows of 4 on
an 8 x 8 grid that they pad), narrow heads, a 128 x 128 bucket and f32
products (the program and the reference then agree to rounding), and the
cell's traffic at small image sizes. The pooler runs its plain twin
(``pooler_impl: pallas`` on the CPU), as the reference does."""
from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)

TINY = {
    "model.compute_dtype": "float32",
    "model.backbone.vit_dim": 32,
    "model.backbone.vit_depth": 3,
    "model.backbone.vit_num_heads": 2,
    "model.backbone.vit_window_size": 5,
    "model.backbone.vit_global_blocks": [2],
    "model.fpn.out_channels": 16,
    "model.roi_heads.pooler_impl": "pallas",
    "model.roi_heads.batch_size_per_image": 32,
    "model.roi_heads.box_head.conv_dim": 16,
    "model.roi_heads.box_head.num_conv": 2,
    "model.roi_heads.box_head.fc_dim": 32,
    "model.roi_heads.mask_head.conv_dim": 16,
    "model.roi_heads.mask_head.num_conv": 2,
    "model.rpn.pre_nms_topk_train": 64,
    "model.rpn.post_nms_topk_train": 64,
    "model.rpn.batch_size_per_image": 32,
    "input.lsj_image_size": 128,
    "input.pad_buckets": [[128, 128]],
    "solver.ims_per_batch": 2,
    "dataloader.num_workers": 2,
}


def tiny_cell(tmp: str):
    """(configuration file, traffic) of the tiny ViTDet cell, written under
    ``tmp``."""
    import yaml

    with open(os.path.join(PORTBENCH, "configs", "cascade-mask-rcnn-vitdet-l.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(TINY)
    path = os.path.join(tmp, "tiny_vitdet.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    with open(os.path.join(PORTBENCH, "workloads", "vitdet-l-train.json")) as f:
        tr = json.load(f)
    tr["data"]["images"] = {"long_side": 96, "short_sides": [64, 80]}
    tr["data"]["instances"].update(max=6, mean=3)
    tr["trace_steps"] = 2
    return path, tr
