"""The port's data-parallel inference step (``engine/trainer.py::make_eval_step``)
against the JAX package's (``u2seg_tpu/engine/trainer.py::make_eval_step``, a
``shard_map`` over a one-device CPU mesh) on the same weights and images,
and two gloo processes against one.

A seeded port model at a tiny config (R50 depth, narrow widths, 7 classes,
f32, ``pooler_impl="gather"`` on both sides, randomised biases and BN
statistics, lowered fusion thresholds) is converted with the JAX package's
``convert_d2_panoptic_fpn``; both steps run on b=2 numpy images.
Tolerances as in ``tests/test_torch_model.py``: f32 rtol 1e-4 with atol
1e-4 * max|ref|; validity, classes, panoptic ids and segment tables exactly.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2seg_tpu.config import config as jconfig
from u2seg_tpu.engine.checkpoint import convert_d2_panoptic_fpn
from u2seg_tpu.engine.trainer import make_eval_step as jmake_eval_step
from u2seg_tpu.models.panoptic_fpn import PanopticFPN as JPanopticFPN
from u2seg_tpu.parallel.mesh import create_mesh as jcreate_mesh
from u2seg_torch import config as tconfig
from u2seg_torch.engine.trainer import make_eval_step
from u2seg_torch.models.build import build_model

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def close(got, ref, rtol=1e-4):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    atol = 1e-4 * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def exact(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(ref))


def same_outputs(got, ref, combine=True):
    exact(got.detections.valid, ref.detections.valid)
    assert int(np.asarray(ref.detections.valid).sum()) > 10
    exact(got.detections.classes, ref.detections.classes)
    close(got.detections.boxes, ref.detections.boxes)
    close(got.detections.scores, ref.detections.scores)
    close(got.sem_seg_logits, ref.sem_seg_logits)
    if not combine:
        assert got.panoptic is None and ref.panoptic is None
        return
    exact(got.panoptic, ref.panoptic)
    for name in ("seg_category", "seg_is_thing", "seg_valid", "seg_instance_idx"):
        exact(getattr(got, name), getattr(ref, name))
    close(got.seg_score, ref.seg_score)


@pytest.fixture(scope="module")
def case():
    cfg_t, cfg_j = tiny(tconfig.Config()), tiny(jconfig.Config())
    rng = np.random.RandomState(0)
    model = build_model(cfg_t, device="cpu")
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith(("running_mean", ".bias")):
                v.copy_(torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.1))
            elif k.endswith(("running_var", "norm.weight")):
                v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
        model.roi_heads.mask_head.predictor.weight.mul_(300.0)
    images = (rng.rand(2, 128, 128, 3) * 255).astype(np.float32)
    sizes = np.array([[128, 128], [120, 100]], np.int32)
    return cfg_t, cfg_j, model, images, sizes


@pytest.mark.parametrize("combine", [True, False])
def test_eval_step_matches_jax_on_one_device(case, combine):
    cfg_t, cfg_j, model, images, sizes = case
    params, stats = convert_d2_panoptic_fpn(
        {k: v.numpy() for k, v in model.state_dict().items()})
    mesh = jcreate_mesh(devices=jax.devices()[:1])
    ref = jmake_eval_step(JPanopticFPN(cfg_j.model), mesh, combine=combine)(
        params, stats, jnp.asarray(images), jnp.asarray(sizes))
    model.train()                                # the step puts it in eval mode
    got = make_eval_step(model, combine=combine)(torch.from_numpy(images),
                                                 torch.from_numpy(sizes))
    assert not model.training
    same_outputs(got, ref, combine)


WORKER = """
import sys
import torch
sys.path.insert(0, {root!r})
from u2seg_torch.engine.trainer import make_eval_step
from u2seg_torch.models.build import build_model
from u2seg_torch.parallel.launch import launch


def main(rank, in_file, out_file):
    inp = torch.load(in_file, weights_only=False)
    model = build_model(inp["cfg"], device="cpu")
    model.load_state_dict(inp["state"])
    torch.save(make_eval_step(model)(inp["images"], inp["sizes"]), out_file % rank)


torch.set_num_threads(1)
rank = int(sys.argv[1])
launch(main, backend="gloo", init_method=sys.argv[2], world_size=2, rank=rank,
       args=(rank, sys.argv[3], sys.argv[4]))
"""


def test_two_gloo_ranks_give_the_one_process_outputs(case, tmp_path):
    cfg_t, _, model, images, sizes = case
    images_t, sizes_t = torch.from_numpy(images), torch.from_numpy(sizes)
    ref = make_eval_step(model)(images_t, sizes_t)
    in_file = str(tmp_path / "in.pt")
    torch.save(dict(cfg=cfg_t, state=model.state_dict(), images=images_t, sizes=sizes_t),
               in_file)
    out_file = str(tmp_path / "out%d.pt")
    init = "file://" + str(tmp_path / "rendezvous")
    code = WORKER.format(root=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), init, in_file, out_file],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    for r in range(2):
        got = torch.load(out_file % r, weights_only=False)
        assert got.panoptic.shape == ref.panoptic.shape            # the whole batch
        same_outputs(got, ref)
