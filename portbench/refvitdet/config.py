"""The reference's configuration: ``portbench.refmodel.config``'s tree with
the fields the ViTDet cell adds (each documented where the port defines
it: the trunk's switches, the RPN head's convs, AdamW and the layer-wise lr
decay), read from the same flattened file by the same merge rules."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from portbench.refmodel import config as base


@dataclass
class BackboneConfig:
    name: str = "ViTDet"
    vit_patch_size: int = 16
    vit_dim: int = 768
    vit_depth: int = 12
    vit_num_heads: int = 12
    vit_window_size: int = 14
    vit_global_blocks: Tuple[int, ...] = (2, 5, 8, 11)
    vit_use_rel_pos: bool = False
    vit_drop_path_rate: float = 0.0
    vit_in_compute_dtype: bool = False
    vit_sdpa: bool = False


@dataclass
class RPNConfig(base.RPNConfig):
    head_conv_dims: Tuple[int, ...] = (-1,)


@dataclass
class ModelConfig(base.ModelConfig):
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    rpn: RPNConfig = field(default_factory=RPNConfig)


@dataclass
class SolverConfig(base.SolverConfig):
    optimizer: str = "SGD"
    vit_lr_decay_rate: float = 1.0
    no_weight_decay: Tuple[str, ...] = ()


@dataclass
class Config(base.Config):
    model: ModelConfig = field(default_factory=ModelConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)


def load_config(overrides: Optional[List[str]] = None) -> Config:
    """A Config from ``key.path=value`` overrides (the configuration file's
    flattened keys and the run's own), as the port's ``load_config`` reads
    them."""
    import yaml

    cfg = Config()
    for ov in overrides or []:
        key, _, raw = ov.partition("=")
        node: dict = {}
        leaf = node
        parts = key.split(".")
        for p in parts[:-1]:
            leaf[p] = {}
            leaf = leaf[p]
        leaf[parts[-1]] = yaml.safe_load(raw)
        cfg = base._merge_into_dataclass(cfg, node)
    rh = dataclasses.replace(cfg.model.roi_heads, mask_on=cfg.model.mask_on,
                             keypoint_on=cfg.model.keypoint_on)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, roi_heads=rh))
