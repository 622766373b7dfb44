"""The detector families of u2seg_torch on the card: the R-CNN paths launch
the multilevel ROIAlign kernels (K1 forward, K3 backward) once per pool, and
agree with the CPU (the kernels' plain versions) on a tiny config.

Launches per call: a Standard head with masks 2 K1 (box, mask), Keypoint
R-CNN 2 (box, keypoint), Cascade Mask R-CNN 4 (3 box stages, mask); a Mask
R-CNN or Keypoint R-CNN loss + backward 2 K1 + 2 K3. The dense detectors,
ProposalNetwork and SemanticSegmentor pool nothing: 0.

These tests need a CUDA device: they carry the ``cuda`` marker and skip
where there is none (a CUDA kernel has no CPU mode). This file imports no
JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_zoo_cuda.py

Tolerance card vs CPU (f32, TF32 off, ``pooler_impl="pallas"`` on both):
boxes and scores of the detections both devices keep rtol 1e-4 with atol
1e-4 * max|cpu|, classes and validity equal.
"""
import numpy as np
import pytest
import torch

from u2seg_torch import config as tconfig
from u2seg_torch.models.build import build_model
from u2seg_torch.ops import roi_align_ml as rap
from u2seg_torch.structures.instances import GtInstances

pytestmark = pytest.mark.cuda

FAMILIES = {
    "mask": ("GeneralizedRCNN", {"name": "StandardROIHeads"}, 2),
    "keypoint": ("GeneralizedRCNN", {"name": "StandardROIHeads", "keypoint_on": True,
                                     "mask_on": False}, 2),
    "cascade_mask": ("GeneralizedRCNN", {"name": "CascadeROIHeads"}, 4),
    "retinanet": ("RetinaNet", {}, 0),
    "fcos": ("FCOS", {}, 0),
    "rpn": ("ProposalNetwork", {}, 0),
    "sem": ("SemanticSegmentor", {}, 0),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def tiny(meta, heads):
    cfg = tconfig.Config()
    m = cfg.model
    m.meta_architecture = meta
    m.compute_dtype = "float32"
    m.resnet.depth = 18
    m.resnet.width_per_group = 8
    m.resnet.stem_out_channels = 16
    m.resnet.res2_out_channels = 32
    m.fpn.out_channels = 32
    m.rpn.pre_nms_topk_test = m.rpn.pre_nms_topk_train = 200
    m.rpn.post_nms_topk_test = m.rpn.post_nms_topk_train = 100
    rh = m.roi_heads
    rh.pooler_impl = "pallas"
    rh.num_classes = 7
    rh.box_head.fc_dim = 64
    rh.mask_head.conv_dim = 32
    rh.keypoint_head.conv_dims = (16, 16)
    rh.detections_per_image = 20
    rh.score_thresh_test = 0.0
    m.retinanet.num_classes = m.fcos.num_classes = 5
    m.sem_seg_head.conv_dim = 32
    m.sem_seg_head.num_classes = 5
    rh.mask_on = m.mask_on = heads.get("mask_on", True)
    rh.keypoint_on = m.keypoint_on = heads.get("keypoint_on", False)
    rh.name = heads.get("name", rh.name)
    return cfg


def images(dev, b=2, hw=128):
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.rand(b, hw, hw, 3) * 255).astype(np.float32)).to(dev)
    return x, torch.tensor([[hw, hw]] * b, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_inference_launches_k1_once_per_pool(dev, family):
    meta, heads, want = FAMILIES[family]
    model = build_model(tiny(meta, heads), device=dev)
    x, s = images(dev)
    rap.multilevel_roi_align_kernel.launches = 0
    out = model(x, s)
    torch.cuda.synchronize()
    assert rap.multilevel_roi_align_kernel.launches == want
    leaf = out if isinstance(out, torch.Tensor) else out.boxes
    assert bool(torch.isfinite(leaf).all())


@pytest.mark.parametrize("family", ["mask", "keypoint"])
def test_training_launches_k1_and_k3_once_per_pool(dev, family):
    meta, heads, _ = FAMILIES[family]
    model = build_model(tiny(meta, heads), device=dev).train()
    x, s = images(dev)
    rng = np.random.RandomState(1)
    xy = rng.rand(2, 3, 2) * 60
    boxes = np.concatenate([xy, xy + rng.rand(2, 3, 2) * 50 + 10], -1).astype(np.float32)
    kp = np.concatenate([boxes[..., None, :2] + rng.rand(2, 3, 17, 2) * 10,
                         np.full((2, 3, 17, 1), 2.0)], -1).astype(np.float32)
    gt = GtInstances(torch.from_numpy(boxes), torch.randint(0, 7, (2, 3)),
                     torch.ones(2, 3, dtype=torch.bool),
                     torch.from_numpy(rng.rand(2, 3, 32, 32).astype(np.float32)),
                     torch.from_numpy(kp)).to(dev)
    rap.multilevel_roi_align_kernel.launches = 0
    rap.multilevel_roi_align_backward.launches = 0
    losses = model(x, s, gt=gt, train=True, generator=torch.Generator(device=dev).manual_seed(0))
    sum(losses.values()).backward()
    torch.cuda.synchronize()
    assert rap.multilevel_roi_align_kernel.launches == 2
    assert rap.multilevel_roi_align_backward.launches == 2
    assert ("loss_keypoint" in losses) == (family == "keypoint")
    assert all(bool(torch.isfinite(v)) for v in losses.values())


@pytest.mark.parametrize("family", ["mask", "keypoint", "cascade_mask"])
def test_card_matches_the_cpu(dev, family):
    meta, heads, _ = FAMILIES[family]
    cfg = tiny(meta, heads)
    gpu, cpu = build_model(cfg, device=dev, seed=2), build_model(cfg, device="cpu", seed=2)
    x, s = images(dev)
    with torch.no_grad():
        features = cpu.features(x.cpu())
        prop = cpu.proposal_generator(features, s.cpu())
        args = (prop.proposal_boxes, prop.proposal_scores, prop.proposal_valid)
        c = cpu.roi_heads(features, *args, s.cpu())
        g = gpu.roi_heads({k: v.to(dev) for k, v in features.items()},
                          *(a.to(dev) for a in args), s).to("cpu")
    assert torch.equal(c.valid, g.valid) and torch.equal(c.classes, g.classes)
    for name in ("boxes", "scores"):
        a, b = getattr(c, name), getattr(g, name)
        assert torch.allclose(b, a, rtol=1e-4, atol=1e-4 * float(a.abs().max())), name
