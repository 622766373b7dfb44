"""The whole u2seg_torch inference forward vs the JAX package's PanopticFPN.

A seeded port model at a tiny config (R50 depth, narrow widths, 7 classes,
f32, ``pooler_impl="gather"`` on both sides) is converted with the JAX
package's ``convert_d2_panoptic_fpn``; ``PanopticFPN.apply(...,
train=False, combine=True)`` and the port's forward then run on the same
b=2 numpy images. Biases, norm affines and BN statistics are randomized;
the fusion thresholds are lowered so instances as well as stuff are painted.

Tolerances: f32 rtol 1e-4 with atol 1e-4 * max|ref|; discrete outputs
(validity, classes, panoptic ids, segment tables) exact. Mask logits are
held to the JAX package per head in ``test_torch_heads.py``: here they sit
downstream of three cascade refinements of the boxes, whose f32 rounding
they amplify.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2seg_tpu.config import config as jconfig
from u2seg_tpu.engine.checkpoint import convert_d2_panoptic_fpn
from u2seg_tpu.models.panoptic_fpn import PanopticFPN as JPanopticFPN
from u2seg_torch import config as tconfig
from u2seg_torch.models.build import build_model

torch.set_num_threads(1)

YAML = os.path.join(os.path.dirname(__file__), "..", "configs",
                    "COCO-PanopticSegmentation", "u2seg_R50_800.yaml")


def close(got, ref, rtol=1e-4):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    atol = 1e-4 * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def exact(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(ref))


def tiny(cfg):
    m = cfg.model
    m.compute_dtype = "float32"
    m.resnet.width_per_group = 8
    m.resnet.stem_out_channels = 16
    m.resnet.res2_out_channels = 32
    m.fpn.out_channels = 32
    m.rpn.pre_nms_topk_test = 200
    m.rpn.post_nms_topk_test = 100
    m.roi_heads.num_classes = 7
    m.roi_heads.box_head.fc_dim = 64
    m.roi_heads.mask_head.conv_dim = 32
    m.roi_heads.detections_per_image = 20
    m.roi_heads.pooler_impl = "gather"
    m.sem_seg_head.conv_dim = 32
    m.sem_seg_head.num_classes = 5
    m.panoptic.instance_conf_thresh = 0.1
    m.panoptic.stuff_area_limit = 256
    return cfg


def randomize(model, rng):
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith(("running_mean", ".bias")):
                v.copy_(torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.1))
            elif k.endswith(("running_var", "norm.weight")):
                v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
        # spread the mask logits so the 0.5 paste threshold is decisive
        model.roi_heads.mask_head.predictor.weight.mul_(300.0)
    return model


@pytest.fixture(scope="module")
def outputs():
    cfg_t, cfg_j = tiny(tconfig.Config()), tiny(jconfig.Config())
    rng = np.random.RandomState(0)
    model = randomize(build_model(cfg_t, device="cpu"), rng)
    params, stats = convert_d2_panoptic_fpn(
        {k: v.numpy() for k, v in model.state_dict().items()})
    images = (rng.rand(2, 128, 128, 3) * 255).astype(np.float32)
    sizes = np.array([[128, 128], [120, 100]], np.int32)
    jm = JPanopticFPN(cfg_j.model)
    ref = jax.jit(lambda v, x, s: jm.apply(v, x, s, train=False, combine=True))(
        {"params": params, "batch_stats": stats}, jnp.asarray(images),
        jnp.asarray(sizes))
    got = model(torch.from_numpy(images), torch.from_numpy(sizes), combine=True)
    return ref, got


def test_detections_match_jax(outputs):
    ref, got = outputs
    exact(got.detections.valid, ref.detections.valid)
    assert int(np.asarray(ref.detections.valid).sum()) > 10
    exact(got.detections.classes, ref.detections.classes)
    close(got.detections.boxes, ref.detections.boxes)
    close(got.detections.scores, ref.detections.scores)


def test_sem_seg_logits_match_jax(outputs):
    ref, got = outputs
    assert got.sem_seg_logits.shape == ref.sem_seg_logits.shape
    close(got.sem_seg_logits, ref.sem_seg_logits)


def test_panoptic_fusion_matches_jax(outputs):
    ref, got = outputs
    exact(got.panoptic, ref.panoptic)
    for name in ("seg_category", "seg_is_thing", "seg_valid", "seg_instance_idx"):
        exact(getattr(got, name), getattr(ref, name))
    close(got.seg_score, ref.seg_score)
    # both instances and stuff were painted
    valid, thing = np.asarray(ref.seg_valid), np.asarray(ref.seg_is_thing)
    assert (valid & thing).sum() > 0 and (valid & ~thing).sum() > 0


def jax_view(tree: dict, root: str = "") -> dict:
    """``tree`` (the port's ``to_dict`` of the config, or of its node at
    ``root``) without the fields the JAX package lacks, each checked to hold
    its default."""
    default = tconfig.to_dict(tconfig.Config())
    for p in filter(None, root.split(".")):
        default = default[p]
    for path in tconfig.PORT_FIELDS:
        if path.startswith(root):
            *parents, leaf = path[len(root):].split(".")
            node, dnode = tree, default
            for p in parents:
                node, dnode = node[p], dnode[p]
            assert node.pop(leaf) == dnode[leaf], path
    return tree


@pytest.mark.parametrize("overrides", [[], ["model.roi_heads.num_classes=300",
                                            "model.compute_dtype=float32"]])
def test_u2seg_yaml_loads_the_same(overrides):
    ref = jconfig.to_dict(jconfig.load_config(YAML, overrides))
    got = jax_view(tconfig.to_dict(tconfig.load_config(YAML, overrides)))
    assert got == ref
    assert got["model"]["roi_heads"]["name"] == "CascadeROIHeads"


CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
ZOO = sorted(os.path.relpath(os.path.join(d, f), CONFIG_DIR)
             for d, _, files in os.walk(CONFIG_DIR) for f in files if f.endswith(".yaml"))


@pytest.mark.parametrize("name", ZOO)
def test_every_zoo_yaml_loads_the_same(name):
    path = os.path.join(CONFIG_DIR, name)
    assert jax_view(tconfig.to_dict(tconfig.load_config(path))) == jconfig.to_dict(
        jconfig.load_config(path))


def test_the_zoo_is_all_there():
    assert len(ZOO) == 34 and "COCO-PanopticSegmentation/u2seg_R50_800.yaml" in ZOO
