"""Model-zoo API (counterpart of ``u2seg_tpu/model_zoo.py``): resolve the
zoo-relative paths of ``configs/`` and build models from them.

    model, cfg = model_zoo.get("COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml",
                               device="cuda")

``get`` builds on ``cuda`` unless ``device`` names another device, and with
``trained=True`` loads ``cfg.model.weights`` (a detectron2 ``.pkl`` / ``.pth``
or a port checkpoint) through ``engine.checkpoint.load_model_weights``.
"""
from __future__ import annotations

import dataclasses
import glob
import os
from typing import Optional, Tuple, Union

import torch

from u2seg_torch.config import Config, load_config

_CONFIG_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")


def get_config_file(config_path: str) -> str:
    """Zoo-relative path (e.g. ``COCO-Detection/faster_rcnn_R_50_FPN_1x.yaml``)
    -> absolute path of the YAML file; ``RuntimeError`` if there is none."""
    cfg_file = os.path.abspath(os.path.join(_CONFIG_ROOT, config_path))
    if not os.path.isfile(cfg_file):
        raise RuntimeError(f"{config_path} is not in the model zoo!")
    return cfg_file


def get_config(config_path: str, trained: bool = False) -> Config:
    """The zoo config; ``trained=False`` clears ``model.weights``."""
    cfg = load_config(get_config_file(config_path))
    if not trained:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, weights=""))
    return cfg


def get(config_path: str, trained: bool = False,
        device: Optional[Union[str, torch.device]] = None) -> Tuple[torch.nn.Module, Config]:
    """-> (model in eval mode on ``device``, its config). The weights are
    the port's seeded init, or with ``trained`` and ``model.weights`` set,
    that file's."""
    from u2seg_torch.models.build import build_model

    cfg = get_config(config_path, trained=trained)
    model = build_model(cfg, device=device)
    if trained and cfg.model.weights:
        from u2seg_torch.engine.checkpoint import load_model_weights

        load_model_weights(model, cfg.model.weights)
    return model, cfg


def list_configs() -> Tuple[str, ...]:
    """Every zoo-relative config path (the ``Base-*`` files left out)."""
    paths = glob.glob(os.path.join(_CONFIG_ROOT, "**", "*.yaml"), recursive=True)
    return tuple(sorted(os.path.relpath(p, _CONFIG_ROOT) for p in paths
                        if not os.path.basename(p).startswith("Base-")))
