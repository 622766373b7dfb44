"""u2seg_torch weight bridge: ``from_jax`` inverts the JAX package's
``convert_d2_panoptic_fpn`` exactly, and the seeded init is deterministic.

Round trip: a seeded (and randomized) port state dict -> the JAX package's
converter -> ``from_jax`` -> the original state dict, bit for bit. A port
loaded through ``from_jax`` then computes the same forward, bit for bit on
the CPU.
"""
import numpy as np
import pytest
import torch

from u2seg_tpu.engine.checkpoint import convert_d2_panoptic_fpn
from u2seg_torch.config import Config
from u2seg_torch.models.build import build_model
from u2seg_torch.weights import from_jax

torch.set_num_threads(1)


def tiny(heads="CascadeROIHeads", fpn_norm="SyncBN"):
    cfg = Config()
    m = cfg.model
    m.compute_dtype = "float32"
    m.resnet.width_per_group = 8
    m.resnet.stem_out_channels = 16
    m.resnet.res2_out_channels = 32
    m.fpn.out_channels = 32
    m.fpn.norm = fpn_norm
    m.rpn.pre_nms_topk_test = 100
    m.rpn.post_nms_topk_test = 50
    m.roi_heads.name = heads
    m.roi_heads.num_classes = 7
    m.roi_heads.box_head.fc_dim = 64
    m.roi_heads.mask_head.conv_dim = 32
    m.roi_heads.detections_per_image = 10
    m.roi_heads.pooler_impl = "gather"
    m.sem_seg_head.conv_dim = 32
    m.sem_seg_head.num_classes = 5
    return cfg


def randomized(cfg, seed):
    model = build_model(cfg, device="cpu", seed=seed)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith(("running_mean", ".bias")):
                v.copy_(torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.1))
            elif k.endswith(("running_var", "norm.weight")):
                v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
    return model


def to_numpy_tree(tree):
    return {k: to_numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("heads,fpn_norm", [("CascadeROIHeads", "SyncBN"),
                                            ("StandardROIHeads", "")])
def test_round_trip_is_exact(heads, fpn_norm):
    model = randomized(tiny(heads, fpn_norm), seed=1)
    sd = model.state_dict()
    num_stages = 3 if heads == "CascadeROIHeads" else 1
    params, stats = convert_d2_panoptic_fpn(
        {k: v.numpy() for k, v in sd.items()}, num_stages=num_stages)
    back = from_jax(to_numpy_tree(params), to_numpy_tree(stats))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        assert torch.equal(back[k], v), k


def test_loaded_port_forward_is_bit_identical():
    cfg = tiny()
    src = randomized(cfg, seed=2)
    params, stats = convert_d2_panoptic_fpn(
        {k: v.numpy() for k, v in src.state_dict().items()})
    dst = build_model(cfg, device="cpu", seed=5)
    dst.load_state_dict(from_jax(to_numpy_tree(params), to_numpy_tree(stats)))
    rng = np.random.RandomState(3)
    images = torch.from_numpy((rng.rand(2, 64, 96, 3) * 255).astype(np.float32))
    sizes = torch.tensor([[64, 96], [60, 80]], dtype=torch.int32)
    a = src(images, sizes, combine=True)
    b = dst(images, sizes, combine=True)
    for name in ("boxes", "scores", "classes", "valid", "mask_logits"):
        assert torch.equal(getattr(a.detections, name),
                           getattr(b.detections, name)), name
    for name in ("sem_seg_logits", "panoptic", "seg_valid", "seg_score"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_seeded_init_is_deterministic():
    cfg = tiny()
    a = build_model(cfg, device="cpu", seed=0).state_dict()
    b = build_model(cfg, device="cpu", seed=0).state_dict()
    c = build_model(cfg, device="cpu", seed=1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = "backbone.bottom_up.res3.0.conv2.weight"
    assert not torch.equal(a[w], c[w])
    # the JAX package's initializer scales: kaiming fan-out convs, 0.01
    # normal for cls_score, 0.001 for bbox_pred
    fan_out = a[w].shape[0] * 9
    assert abs(a[w].std().item() / np.sqrt(2.0 / fan_out) - 1) < 0.1
    assert abs(a["roi_heads.box_predictor.0.cls_score.weight"].std().item() / 0.01 - 1) < 0.1
    assert abs(a["roi_heads.box_predictor.0.bbox_pred.weight"].std().item() / 0.001 - 1) < 0.1

    # every meta-architecture and its new modules: same seed, same numbers
    for meta, extra in (("GeneralizedRCNN", {"keypoint_on": True, "num_conv": 2}),
                        ("ProposalNetwork", {}), ("SemanticSegmentor", {}),
                        ("RetinaNet", {}), ("FCOS", {})):
        cfg = tiny("StandardROIHeads", "GN")
        cfg.model.meta_architecture = meta
        cfg.model.retinanet.num_classes = cfg.model.fcos.num_classes = 5
        if extra:
            cfg.model.keypoint_on = cfg.model.roi_heads.keypoint_on = True
            cfg.model.roi_heads.keypoint_head.conv_dims = (16, 16)
            cfg.model.roi_heads.box_head.num_conv = 2
            cfg.model.roi_heads.box_head.norm = "GN"
        a = build_model(cfg, device="cpu", seed=0).state_dict()
        b = build_model(cfg, device="cpu", seed=0).state_dict()
        c = build_model(cfg, device="cpu", seed=1).state_dict()
        assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a), meta
        moved = [k for k in a if k.endswith("weight") and not torch.equal(a[k], c[k])]
        assert len(moved) > 10, meta
        if meta == "GeneralizedRCNN":
            kp = a["roi_heads.keypoint_head.conv_fcn1.weight"]      # kaiming fan-out
            assert abs(kp.std().item() / np.sqrt(2.0 / (16 * 9)) - 1) < 0.1
            gn = a["roi_heads.box_head.conv1.norm.weight"]
            assert torch.equal(gn, torch.ones_like(gn))
        if meta in ("RetinaNet", "FCOS"):                 # normal(0.01), prior bias
            assert abs(a["head.cls_subnet.0.weight"].std().item() / 0.01 - 1) < 0.1
            assert torch.allclose(a["head.cls_score.bias"],
                                  torch.full((5 * (9 if meta == "RetinaNet" else 1),),
                                             -float(np.log(99.0))))
            p6 = a["backbone.top_block.p6.weight"]          # glorot uniform
            lim = np.sqrt(6.0 / (2 * 32 * 9))
            assert float(p6.abs().max()) <= lim and float(p6.abs().max()) > 0.9 * lim
