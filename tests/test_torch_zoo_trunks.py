"""The RegNet, Swin and ViTDet files of the model zoo, shrunk, as whole
GeneralizedRCNN (Mask R-CNN) models of u2seg_torch vs the JAX package on
the CPU: inference, and the training losses of the ViTDet and Swin models.

Each case loads the YAML file in both packages, cuts the trunk to a few
blocks of narrow width and the heads to ``torch_zoo_parity.tiny``'s (f32,
7 classes, 32-channel FPN, the gather pooler), jits the JAX model once with
a variable tree drawn from numpy and loads the same numbers into the port
through ``weights.from_jax`` (strict). The port builds the ViTDet model for
the test's input size (``input.pad_buckets``), as the JAX model is
initialised at it.

Inference (b=2, 128x128 with a 120x100 valid region, as
``test_torch_rcnn.py``): boxes and scores rtol 1e-4 with atol 1e-4 *
max|ref|, classes and validity exact; mask logits rtol 1e-3 with atol 1e-3 *
max|ref| (``test_torch_rcnn.py``'s). Losses (``torch_rcnn_train.batch()``:
b=2, 64x64, 3 gt boxes; RNG-free sampling): every loss rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_rcnn_train import RNG_FREE, _jax_losses, batch
from torch_zoo_parity import jnp_tree, numpy_of, port_from, random_variables, same_detections, tiny
from u2seg_tpu.config import config as jconfig
from u2seg_tpu.models.build import build_model as jbuild
from u2seg_torch import config as tconfig
from u2seg_torch import model_zoo
from u2seg_torch.models.build import build_model
from u2seg_torch.structures.instances import GtInstances

torch.set_num_threads(1)

SHRINK = {
    "Misc/mask_rcnn_regnetx_4gf_fpn_3x.yaml": {
        "backbone.regnet_w_a": 8.0, "backbone.regnet_w_0": 8, "backbone.regnet_w_m": 2.0,
        "backbone.regnet_depth": 6, "backbone.regnet_group_width": 8},
    "Misc/mask_rcnn_swin_t_fpn_3x.yaml": {
        "backbone.embed_dim": 16, "backbone.depths": (2, 2, 2, 2),
        "backbone.trunk_num_heads": (1, 2, 2, 2), "backbone.window_size": 3},
    "ViTDet/mask_rcnn_vitdet_b_100ep.yaml": {
        "backbone.vit_dim": 32, "backbone.vit_depth": 3, "backbone.vit_num_heads": 2,
        "backbone.vit_window_size": 3, "backbone.vit_global_blocks": (1,)},
}
MASK_RCNN_LOSSES = ["loss_box_reg", "loss_cls", "loss_mask", "loss_rpn_cls", "loss_rpn_loc"]


def configs(rel, hw, **over):
    path = model_zoo.get_config_file(rel)
    out = []
    for pkg in (jconfig, tconfig):
        cfg = tiny(pkg.load_config(path), **dict(SHRINK[rel], **over))
        cfg.input.pad_buckets = (hw,)
        out.append(cfg)
    return out


def test_the_shrunk_files_keep_their_trunks():
    for rel in SHRINK:
        cfg_j, cfg_t = configs(rel, (128, 128))
        assert cfg_t.model.meta_architecture == "GeneralizedRCNN" and cfg_t.model.mask_on
        assert cfg_t.model.backbone.name == cfg_j.model.backbone.name != "ResNetFPN"


@pytest.mark.parametrize("rel", sorted(SHRINK), ids=lambda r: r.split("/")[-1][:-5])
def test_zoo_trunk_model_inference_matches_jax(rel):
    cfg_j, cfg_t = configs(rel, (128, 128))
    rng = np.random.RandomState(0)
    images = (rng.rand(2, 128, 128, 3) * 255).astype(np.float32)
    sizes = np.array([[128, 128], [120, 100]], np.int32)
    jm = jbuild(cfg_j)
    v = random_variables(jm, 1, jnp.asarray(images), jnp.asarray(sizes), train=False)
    ref = jax.jit(lambda v, x, s: jm.apply(v, x, s, train=False))(
        jnp_tree(v), jnp.asarray(images), jnp.asarray(sizes))
    model = port_from(v, build_model(cfg_t, device="cpu"))
    got = model(torch.from_numpy(images), torch.from_numpy(sizes))
    n = same_detections(got, ref)
    assert n >= 10, f"only {n} detections: the test would not see decoding and NMS"
    mref = np.asarray(ref.mask_logits)
    np.testing.assert_allclose(numpy_of(got.mask_logits), mref, rtol=1e-3,
                               atol=1e-3 * float(np.abs(mref).max()))


@pytest.mark.parametrize("rel", ["Misc/mask_rcnn_swin_t_fpn_3x.yaml",
                                 "ViTDet/mask_rcnn_vitdet_b_100ep.yaml"],
                         ids=lambda r: r.split("/")[-1][:-5])
def test_zoo_trunk_model_losses_match_jax(rel):
    bt = batch()
    cfg_j, cfg_t = configs(rel, bt["images"].shape[1:3], **RNG_FREE)
    jm = jbuild(cfg_j)
    v = random_variables(jm, 7, jnp.asarray(bt["images"]), jnp.asarray(bt["sizes"]),
                         train=False)
    ref, _ = _jax_losses(jm, "GeneralizedRCNN", bt, v)
    model = port_from(v, build_model(cfg_t, device="cpu")).train()
    gt = GtInstances(*(torch.from_numpy(bt[k]) for k in ("boxes", "classes", "valid",
                                                          "masks", "keypoints")))
    losses = model(torch.from_numpy(bt["images"]), torch.from_numpy(bt["sizes"]), gt=gt,
                   train=True, generator=torch.Generator().manual_seed(0))
    assert sorted(losses) == sorted(ref) == MASK_RCNN_LOSSES
    for k in MASK_RCNN_LOSSES:
        got = float(losses[k].detach())
        assert np.isfinite(got) and got > 0, k
        np.testing.assert_allclose(got, float(ref[k]), rtol=1e-4, err_msg=k)
    sum(losses.values()).backward()
    trunk = [p.grad for k, p in model.named_parameters() if k.startswith("backbone.")]
    assert trunk and all(g is not None and bool(torch.isfinite(g).all()) for g in trunk)
