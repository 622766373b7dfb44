"""Configuration: typed dataclasses + YAML with ``_BASE_`` inheritance.

The port's own copy of the JAX package's config tree (same fields, same
defaults, same merge rules), so one YAML file from ``configs/`` builds the
same model in both packages. ``yaml`` is imported only where a file or an
override is parsed: the default ``Config()`` needs nothing beyond the
standard library.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

@dataclass
class ResNetConfig:
    depth: int = 50
    norm: str = "SyncBN"                      # u2seg: SyncBN (yaml NORM)
    stride_in_1x1: bool = False               # torchvision/DINO style
    freeze_at: int = 0                        # u2seg freezes nothing
    out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")
    num_groups: int = 1
    width_per_group: int = 64
    stem_out_channels: int = 64
    res2_out_channels: int = 256


@dataclass
class BackboneConfig:
    """Backbone selection (ref MODEL.BACKBONE.NAME + per-family fields).

    ``name`` keys into ``models/backbone.py`` BACKBONE_REGISTRY:
    ResNetFPN (default; uses ``resnet``+``fpn`` namespaces), ViTDet
    (``vit_*`` fields + SimpleFeaturePyramid), SwinFPN / MViTFPN
    (``embed_dim``/``depths``/``trunk_num_heads``/``window_size`` + FPN),
    RegNetFPN (``regnet_*`` + FPN).
    """

    name: str = "ResNetFPN"
    # ViTDet trunk (ref projects/ViTDet ViT-B/16 defaults)
    vit_patch_size: int = 16
    vit_dim: int = 768
    vit_depth: int = 12
    vit_num_heads: int = 12
    vit_window_size: int = 14
    vit_global_blocks: Tuple[int, ...] = (2, 5, 8, 11)
    # detectron2's decomposed relative positions (``add_decomposed_rel_pos``):
    # tables of (2 * window - 1, head dim) in windowed blocks and (2 * grid -
    # 1, head dim) in global ones. Off: no relative term, as the JAX module
    vit_use_rel_pos: bool = False
    # stochastic depth: block i drops each residual branch of a sample with
    # probability linspace(0, rate, depth)[i] in training, drawn from the
    # step's generator. 0: none, as the JAX module
    vit_drop_path_rate: float = 0.0
    # the trunk and the pyramid compute in ``model.compute_dtype`` (products
    # in it; norm statistics, softmax and the residual stream in f32; the
    # levels leave in it). Off: f32 whatever the compute dtype, as the JAX
    # package builds them
    vit_in_compute_dtype: bool = False
    # attention through ``F.scaled_dot_product_attention`` (the relative
    # positions as its ``attn_mask``). Off: plain ``q @ k^T``, softmax, ``@ v``
    vit_sdpa: bool = False
    # Swin-T / MViTv2-T trunks
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    trunk_num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    # RegNetX-4GF-ish
    regnet_w_a: float = 38.65
    regnet_w_0: int = 96
    regnet_w_m: float = 2.43
    regnet_depth: int = 23
    regnet_group_width: int = 40


@dataclass
class FPNConfig:
    in_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")
    out_channels: int = 256
    norm: str = "SyncBN"                      # u2seg FPN NORM: SyncBN
    top_block: str = "maxpool"                # p6 via max-pool (RCNN-FPN)
    fuse_type: str = "sum"


@dataclass
class AnchorConfig:
    sizes: Tuple[Tuple[float, ...], ...] = ((32,), (64,), (128,), (256,), (512,))
    aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    offset: float = 0.0


@dataclass
class RPNConfig:
    in_features: Tuple[str, ...] = ("p2", "p3", "p4", "p5", "p6")
    iou_thresholds: Tuple[float, float] = (0.3, 0.7)
    batch_size_per_image: int = 256
    positive_fraction: float = 0.5
    bbox_reg_weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    smooth_l1_beta: float = 0.0
    loss_weight: float = 1.0
    # u2seg overrides (u2seg_R50_800.yaml:15-17): train 4000 post-NMS, 0.65 NMS
    pre_nms_topk_train: int = 2000            # per level
    pre_nms_topk_test: int = 1000
    post_nms_topk_train: int = 4000
    post_nms_topk_test: int = 1000
    nms_thresh: float = 0.65
    min_size: float = 0.0
    boundary_thresh: float = -1.0
    # the head's 3x3 convs before its two predictors, each with a relu
    # (detectron2's ``RPN.HEAD.CONV_DIMS``; -1: the input's channels). One:
    # ``rpn_head.conv``; more: ``rpn_head.conv.conv0``, ``.conv1``, ...
    head_conv_dims: Tuple[int, ...] = (-1,)


@dataclass
class ROIBoxHeadConfig:
    num_fc: int = 2
    fc_dim: int = 1024
    num_conv: int = 0
    conv_dim: int = 256
    pooler_resolution: int = 7
    pooler_sampling_ratio: int = 0
    norm: str = ""


@dataclass
class ROIMaskHeadConfig:
    num_conv: int = 4
    conv_dim: int = 256
    pooler_resolution: int = 14
    pooler_sampling_ratio: int = 0
    norm: str = ""
    cls_agnostic_mask: bool = False


@dataclass
class ROIKeypointHeadConfig:
    """ref defaults.py ROI_KEYPOINT_HEAD namespace."""

    num_keypoints: int = 17
    conv_dims: Tuple[int, ...] = (512,) * 8
    pooler_resolution: int = 14
    pooler_sampling_ratio: int = 0
    loss_weight: float = 1.0
    # None -> normalize by visible keypoint count (the reference's
    # NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS=True); a float uses
    # num_images * keypoint_batch_size semantics instead
    normalizer: Optional[float] = None


@dataclass
class ROIHeadsConfig:
    name: str = "CascadeROIHeads"             # u2seg uses cascade
    # ROI pooling backend: "gather" (plain tensor ops, sqrt-area routing),
    # "pallas" (the multilevel ROIAlign kernel: the hand-written CUDA kernel
    # on a GPU, its plain twin on the CPU), "auto" (pallas on cuda, gather
    # on the CPU). The names are the JAX package's, so one YAML serves both.
    pooler_impl: str = "auto"
    num_classes: int = 800                    # CLUSTER_NUM as real config
    in_features: Tuple[str, ...] = ("p2", "p3", "p4", "p5")
    iou_thresholds: Tuple[float, ...] = (0.5,)
    batch_size_per_image: int = 512
    positive_fraction: float = 0.25
    score_thresh_test: float = 0.05
    nms_thresh_test: float = 0.5
    detections_per_image: int = 100
    cls_agnostic_bbox_reg: bool = True        # u2seg: True
    bbox_reg_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)
    smooth_l1_beta: float = 0.0
    # cascade (ref cascade_rcnn.py:118-135, defaults.py:334-341)
    cascade_ious: Tuple[float, ...] = (0.5, 0.6, 0.7)
    cascade_bbox_reg_weights: Tuple[Tuple[float, ...], ...] = (
        (10.0, 10.0, 5.0, 5.0),
        (20.0, 20.0, 10.0, 10.0),
        (30.0, 30.0, 15.0, 15.0),
    )
    box_head: ROIBoxHeadConfig = field(default_factory=ROIBoxHeadConfig)
    mask_head: ROIMaskHeadConfig = field(default_factory=ROIMaskHeadConfig)
    mask_on: bool = True
    keypoint_head: "ROIKeypointHeadConfig" = field(
        default_factory=lambda: ROIKeypointHeadConfig())
    keypoint_on: bool = False


@dataclass
class RetinaNetConfig:
    """ref defaults.py MODEL.RETINANET namespace (retinanet.py:29)."""

    num_classes: int = 80
    in_features: Tuple[str, ...] = ("p3", "p4", "p5", "p6", "p7")
    iou_thresholds: Tuple[float, float] = (0.4, 0.5)
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    smooth_l1_beta: float = 0.0
    box_reg_weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    score_thresh: float = 0.05
    topk_candidates: int = 1000
    nms_thresh: float = 0.5
    max_detections: int = 100
    # head-BN experiments (projects/Rethinking-BatchNorm)
    head_norm: str = ""
    head_shared_bn: bool = False


@dataclass
class FCOSConfig:
    """ref defaults.py MODEL.FCOS namespace (fcos.py:25)."""

    num_classes: int = 80
    in_features: Tuple[str, ...] = ("p3", "p4", "p5", "p6", "p7")
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    center_sampling_radius: float = 1.5
    score_thresh: float = 0.05
    topk_candidates: int = 1000
    nms_thresh: float = 0.6
    max_detections: int = 100
    # per-level regression ranges (ref fcos.py): boxes are assigned to the
    # level whose max-ltrb distance falls in range
    size_ranges: Tuple[Tuple[float, float], ...] = (
        (0, 64), (64, 128), (128, 256), (256, 512), (512, float("inf")),
    )
    head_norm: str = ""


@dataclass
class SemSegHeadConfig:
    in_features: Tuple[str, ...] = ("p2", "p3", "p4", "p5")
    num_classes: int = 28                     # 27 STEGO stuff + 1 "things"
    conv_dim: int = 128
    common_stride: int = 4
    norm: str = "GN"
    loss_weight: float = 0.5
    ignore_value: int = 255


@dataclass
class PanopticConfig:
    instance_conf_thresh: float = 0.5
    overlap_thresh: float = 0.5
    stuff_area_limit: int = 4096
    combine_on: bool = True


@dataclass
class ModelConfig:
    meta_architecture: str = "PanopticFPN"
    # computation dtype for convs/matmuls ("bfloat16" = AMP; params and
    # losses stay float32 — the counterpart of SOLVER.AMP.ENABLED)
    compute_dtype: str = "bfloat16"
    # u2seg_R50_800.yaml:3-5 — RGB order + DINO normalization
    pixel_mean: Tuple[float, float, float] = (123.675, 116.280, 103.530)
    pixel_std: Tuple[float, float, float] = (58.395, 57.120, 57.375)
    input_format: str = "RGB"
    mask_on: bool = True
    keypoint_on: bool = False
    weights: str = ""
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    resnet: ResNetConfig = field(default_factory=ResNetConfig)
    fpn: FPNConfig = field(default_factory=FPNConfig)
    anchors: AnchorConfig = field(default_factory=AnchorConfig)
    rpn: RPNConfig = field(default_factory=RPNConfig)
    roi_heads: ROIHeadsConfig = field(default_factory=ROIHeadsConfig)
    retinanet: RetinaNetConfig = field(default_factory=RetinaNetConfig)
    fcos: FCOSConfig = field(default_factory=FCOSConfig)
    sem_seg_head: SemSegHeadConfig = field(default_factory=SemSegHeadConfig)
    panoptic: PanopticConfig = field(default_factory=PanopticConfig)
    # static capacities (TPU): max GT instances per image
    max_gt_instances: int = 100


@dataclass
class InputConfig:
    # u2seg_R50_800.yaml:54-55
    min_size_train: Tuple[int, ...] = (
        240, 320, 480, 640, 672, 704, 736, 768, 800, 1024
    )
    max_size_train: int = 1333
    min_size_test: int = 800
    max_size_test: int = 1333
    random_flip: bool = True
    mask_format: str = "bitmask"
    size_divisibility: int = 32
    # INPUT.CROP recipe (ref defaults.py INPUT.CROP, dataset_mapper.py:49-56)
    crop_enabled: bool = False
    crop_type: str = "relative_range"
    crop_size: Tuple[float, float] = (0.9, 0.9)
    crop_single_category_max_area: float = 1.0
    # large-scale jitter (ResizeScale + FixedSizeCrop, LazyConfig LSJ recipe)
    lsj: bool = False
    lsj_min_scale: float = 0.1
    lsj_max_scale: float = 2.0
    lsj_image_size: int = 1024
    # optional extras
    rotation_enabled: bool = False
    rotation_angles: Tuple[float, ...] = (-30.0, 30.0)
    rotation_expand: bool = True
    rotation_sample_style: str = "range"
    color_aug: bool = False
    # static padded shapes (H, W) buckets for TPU training; images are
    # resized by the multi-scale policy then padded into one of these
    pad_buckets: Tuple[Tuple[int, int], ...] = ((800, 1344), (1344, 800), (1056, 1056))


@dataclass
class SolverConfig:
    # u2seg_R50_800.yaml:26-45
    ims_per_batch: int = 16
    base_lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 5e-5
    weight_decay_norm: float = 0.0
    max_iter: int = 270000
    steps: Tuple[int, ...] = (210000, 250000)
    gamma: float = 0.02
    warmup_iters: int = 1000
    warmup_factor: float = 1.0 / 1000
    warmup_method: str = "linear"
    clip_gradients: bool = True
    clip_type: str = "norm"
    clip_value: float = 1.0
    amp: bool = True                          # on TPU: bf16 compute
    checkpoint_period: int = 10000
    bias_lr_factor: float = 1.0
    weight_decay_bias: Optional[float] = None   # None -> weight_decay
    nesterov: bool = False
    scheduler: str = "WarmupMultiStepLR"
    # "SGD" (momentum, L2 decay added to the gradient) or "AdamW" (decoupled
    # decay; no momentum or nesterov), both on the same schedule and groups
    optimizer: str = "SGD"
    # ViT layer-wise lr decay (detectron2's ``get_vit_lr_decay_rate``): a
    # parameter's lr is scaled by rate ** (layers + 1 - layer_id), layers the
    # ViT trunk's depth, layer_id 0 for its patch_embed and pos_embed, i + 1
    # for ``blocks.i``, layers + 1 elsewhere. Rate 1.0: no decay
    vit_lr_decay_rate: float = 1.0
    # parameters whose own name (the last part of the dotted name) is one of
    # these take no weight decay (detectron2's optimizer ``overrides``;
    # ViTDet: pos_embed)
    no_weight_decay: Tuple[str, ...] = ()


@dataclass
class DataloaderConfig:
    num_workers: int = 4
    filter_empty_annotations: bool = True
    sampler: str = "TrainingSampler"
    repeat_threshold: float = 0.0
    prefetch: int = 2


@dataclass
class DatasetsConfig:
    train: Tuple[str, ...] = ("coco_2017_train_panoptic_separated",)
    test: Tuple[str, ...] = ("coco_2017_val_panoptic_separated",)
    root: str = "datasets"
    cluster_num: int = 800                    # replaces CLUSTER_NUM env var


@dataclass
class TestConfig:
    eval_period: int = 0
    detections_per_image: int = 100
    expected_results: Tuple = ()
    eval_mode: str = "eval"                   # or "hungarian_matching"
    # device batch for dataset evaluation (DefaultPredictor.run_batched);
    # the reference tests one image at a time (defaults.py:253)
    ims_per_batch: int = 8
    # on-device exact full-res render (engine/device_render.py): the eval
    # pipeline fetches RLE panoptic/semantic maps + segment tables instead
    # of raw logits. Images that exceed the canvas / budgets fall back to
    # the exact host render per image.
    device_render: bool = True
    render_canvas: Tuple[int, int] = (640, 640)   # >= any original (oh, ow)
    render_k_fuse: int = 50                       # fusion instance budget
    render_max_runs: int = 16384                  # RLE run budget per map
    # static per-image share of the eagerly-fetched packed-run prefix
    # (engine/device_render.PackedRender); batches with more total runs pay
    # one dynamic-slice fetch instead. 4096 runs = 24 KB/img — still small
    # next to one link RTT, and covers noisy (random-weight bench) maps
    # whose argmax runs far exceed any trained model's
    fetch_runs_per_image: int = 4096
    # upload the RAW uint8 image and resize on device (needs device_render;
    # images that fit no raw bucket fall back to the host-resize path)
    device_resize: bool = True
    raw_buckets: Tuple[Tuple[int, int], ...] = (
        (480, 640), (640, 480), (640, 640)
    )


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    input: InputConfig = field(default_factory=InputConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    dataloader: DataloaderConfig = field(default_factory=DataloaderConfig)
    datasets: DatasetsConfig = field(default_factory=DatasetsConfig)
    test: TestConfig = field(default_factory=TestConfig)
    output_dir: str = "./output"
    seed: int = -1
    version: int = 1


# the fields that the JAX package's Config lacks, as dotted paths: at their
# defaults the port computes what the JAX package computes
PORT_FIELDS = (
    "model.backbone.vit_use_rel_pos", "model.backbone.vit_drop_path_rate",
    "model.backbone.vit_in_compute_dtype", "model.backbone.vit_sdpa",
    "model.rpn.head_conv_dims", "solver.optimizer", "solver.vit_lr_decay_rate",
    "solver.no_weight_decay",
)


# ---------------------------------------------------------------------------
# Load / merge / override machinery
# ---------------------------------------------------------------------------

def _merge_into_dataclass(obj: Any, updates: dict, path: str = "") -> Any:
    """Recursively apply a nested dict onto a dataclass tree (type-coerced)."""
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"{path or '<root>'} is not a config node")
    names = {f.name: f for f in dataclasses.fields(obj)}
    kwargs = {}
    for key, value in updates.items():
        if key == "_BASE_":
            continue
        if key not in names:
            raise KeyError(f"Unknown config key: {path}{key}")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(value, dict):
            kwargs[key] = _merge_into_dataclass(cur, value, f"{path}{key}.")
        else:
            kwargs[key] = _coerce(cur, value, f"{path}{key}")
    return dataclasses.replace(obj, **kwargs)


def _coerce(cur: Any, value: Any, path: str) -> Any:
    """Coerce a YAML value to the type of the current config value."""
    if isinstance(cur, tuple) and isinstance(value, (list, tuple)):
        if cur and isinstance(cur[0], tuple) and value and isinstance(value[0], (list, tuple)):
            return tuple(tuple(v) for v in value)
        return tuple(value)
    if isinstance(cur, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(cur, int) and not isinstance(cur, bool):
        return int(value)
    if isinstance(cur, float):
        return float(value)
    return value


def load_yaml_with_base(path: str) -> dict:
    """Load a YAML config file, resolving ``_BASE_`` inheritance recursively
    (relative to the file, like ref config.py:48-97)."""
    import os

    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    base = cfg.pop("_BASE_", None)
    if base:
        base_path = base if os.path.isabs(base) else os.path.join(
            os.path.dirname(path), base
        )
        merged = load_yaml_with_base(base_path)
        _deep_update(merged, cfg)
        return merged
    return cfg


def _deep_update(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v


def get_cfg() -> Config:
    """Fresh default config (counterpart of ref ``get_cfg`` config.py:99)."""
    return Config()


def load_config(path: Optional[str] = None, overrides: Optional[List[str]] = None) -> Config:
    """Build a Config from an optional YAML file + ``key.path=value`` overrides."""
    cfg = Config()
    if path:
        cfg = _merge_into_dataclass(cfg, load_yaml_with_base(path))
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"Override must be key.path=value, got: {ov}")
        import yaml

        key, _, raw = ov.partition("=")
        value = yaml.safe_load(raw)
        node: dict = {}
        leaf = node
        parts = key.split(".")
        for p in parts[:-1]:
            leaf[p] = {}
            leaf = leaf[p]
        leaf[parts[-1]] = value
        cfg = _merge_into_dataclass(cfg, node)
    # model.mask_on / model.keypoint_on are authoritative for yaml configs
    # (the reference has a single MODEL.MASK_ON / MODEL.KEYPOINT_ON that the
    # heads, mapper and evaluators all key off — ref defaults.py:33,36)
    rh = dataclasses.replace(
        cfg.model.roi_heads,
        mask_on=cfg.model.mask_on,
        keypoint_on=cfg.model.keypoint_on,
    )
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, roi_heads=rh))


def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def save_config(cfg: Config, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(to_dict(cfg), f, sort_keys=False)
