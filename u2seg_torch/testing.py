"""A tiny config and a synthetic training batch (counterpart of
``u2seg_tpu/config/testing.py``), small but complete: cascade heads, SyncBN,
class-agnostic regression. Used by the CPU tests and by the card-vs-CPU
check of the train step.
"""
from __future__ import annotations

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
