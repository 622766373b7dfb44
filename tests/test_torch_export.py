"""``torch.export`` of the port's inference forward
(``u2seg_torch/engine/export.py``) on the CPU, at the tiny config of
``test_torch_model.py`` (R50 depth, narrow widths, 7 classes, f32) and one
64x64 image.

- The loaded program equals the eager forward bit for bit (same ops, same
  order, same device).
- With ``pooler_impl="pallas"`` the graph holds the registered K1 op
  ``u2seg_torch::multilevel_roi_align`` 4 times (3 cascade box pools and the
  mask pool), and the two fixpoints as their registered ops.
- With ``pooler_impl="gather"`` the loaded program's flat outputs match those
  of the JAX package's own ``export_inference(..., platforms=("cpu",))``
  followed by ``load_exported``, on the same weights (the seeded port model
  converted by ``convert_d2_panoptic_fpn``), at the whole-model tolerance of
  ``test_torch_model.py``: f32 rtol 1e-4 with atol 1e-4 * max|ref| (the mask
  logits included), discrete outputs exact.
"""
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from u2seg_tpu.config import config as jconfig
from u2seg_tpu.engine import export as jexport
from u2seg_tpu.engine.checkpoint import convert_d2_panoptic_fpn
from u2seg_tpu.models.panoptic_fpn import PanopticFPN as JPanopticFPN
from u2seg_torch import config as tconfig
from u2seg_torch.engine import export
from u2seg_torch.models.build import build_model

torch.set_num_threads(1)

HW = 64
NAMES = ["detections.boxes", "detections.scores", "detections.classes",
         "detections.valid", "detections.mask_logits", "sem_seg_logits", "panoptic",
         "seg_category", "seg_is_thing", "seg_score", "seg_valid", "seg_instance_idx"]


def tiny(cfg, pooler):
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
    m.roi_heads.pooler_impl = pooler
    m.sem_seg_head.conv_dim = 32
    m.sem_seg_head.num_classes = 5
    m.panoptic.instance_conf_thresh = 0.1
    m.panoptic.stuff_area_limit = 64
    return cfg


def randomize(model, rng):
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith(("running_mean", ".bias")):
                v.copy_(torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.1))
            elif k.endswith(("running_var", "norm.weight")):
                v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
        model.roi_heads.mask_head.predictor.weight.mul_(300.0)
    return model


def inputs():
    rng = np.random.RandomState(3)
    images = (rng.rand(1, HW, HW, 3) * 255).astype(np.float32)
    return images, np.array([[HW, HW - 6]], np.int32)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    out = {}
    for pooler in ("gather", "pallas"):
        model = randomize(build_model(tiny(tconfig.Config(), pooler), device="cpu"),
                          np.random.RandomState(0))
        path = str(tmp_path_factory.mktemp(pooler))
        program = export.export_inference(model, (1, HW, HW, 3), path, device="cpu")
        out[pooler] = (model, path, program)
    return out


def test_loaded_program_equals_the_eager_forward(exported):
    model, path, _ = exported["gather"]
    images, sizes = (torch.from_numpy(a) for a in inputs())
    got = export.load_exported(path)(images, sizes)
    ref = pytree.tree_leaves(model(images, sizes, combine=True))
    schema = export.load_schema(path)
    assert [o["name"] for o in schema["outputs"]] == NAMES and len(got) == len(ref) == 12
    for g, r, o in zip(got, ref, schema["outputs"]):
        assert list(g.shape) == o["shape"] and str(g.dtype) == "torch." + o["dtype"]
        assert torch.equal(g, r), o["name"]
    out = export.unflatten_outputs(got, path)
    assert torch.equal(out.panoptic, ref[6]) and torch.equal(out.detections.boxes, ref[0])
    assert int(out.seg_valid.sum()) > 0


def test_the_graph_holds_k1_four_times_as_a_registered_op(exported):
    nodes = [n.target for n in exported["pallas"][2].graph.nodes if n.op == "call_function"]
    count = lambda op: sum(t is op for t in nodes)  # noqa: E731
    ops = torch.ops.u2seg_torch
    assert count(ops.multilevel_roi_align.default) == 4
    assert count(ops.panoptic_greedy_take.default) == 1          # b=1: one image
    assert count(ops.nms_self_suppression.default) >= 2
    assert not any("aten.equal" in str(t) for t in nodes)      # no host-synced loop left
    model, path, _ = exported["pallas"]
    images, sizes = (torch.from_numpy(a) for a in inputs())
    got = export.load_exported(path)(images, sizes)
    for g, r in zip(got, pytree.tree_leaves(model(images, sizes, combine=True))):
        assert torch.equal(g, r)


def test_gather_program_matches_the_jax_export(exported, tmp_path):
    model, path, _ = exported["gather"]
    params, stats = convert_d2_panoptic_fpn(
        {k: v.numpy() for k, v in model.state_dict().items()})
    jm = JPanopticFPN(tiny(jconfig.Config(), "gather").model)
    jexport.export_inference(jm, {"params": params, "batch_stats": stats},
                             (1, HW, HW, 3), str(tmp_path / "jax"), platforms=("cpu",))
    images, sizes = inputs()
    ref = jexport.load_exported(str(tmp_path / "jax"))(images, sizes)
    got = export.load_exported(path)(torch.from_numpy(images), torch.from_numpy(sizes))
    assert len(ref) == len(got) == 12
    valid = np.asarray(ref[3])
    assert valid.sum() > 3
    for name, g, r in zip(NAMES, got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape, name
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, r, rtol=1e-4,
                                       atol=1e-4 * max(float(np.abs(r).max()), 1e-30),
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)
