"""RetinaNet and FCOS of u2seg_torch vs the JAX package, inference on the
CPU, and the FPN pieces they need (the ``p6p7`` top block, ``fuse_type="avg"``).

Each case jits the JAX meta-architecture once on b=2 numpy images (128x128
and a 120x100 valid region) with a variable tree drawn from numpy
(``torch_zoo_parity.random_variables``). Score calibration: the classifiers
are drawn at std 1/sqrt(fan_in) instead of the packages' 0.01 with the 0.01
prior bias, so class probabilities spread and many pass the unchanged 0.05
test threshold (at the seeded init none would, and box decoding and NMS
would go unexercised). FCOS runs with a GN head, RetinaNet with the zoo's
norm-free head.

Tolerances: boxes and scores rtol 1e-4 with atol 1e-4 * max|ref|; classes and
validity exact; FPN levels rtol 1e-4 with atol 1e-4 * max|ref| in f32. bf16:
the levels at the AMP tolerance (rtol 0.05, atol 0.03 * max|ref|), p6 and p7
f32 in both packages, and at least 75% of the JAX detections found by the
port (same class, box sides within 1 px).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_zoo_parity import (AMP_ATOL, AMP_RTOL, close, jnp_tree, matched_share,
                              numpy_of, port_from, random_variables, same_detections,
                              tiny)
from u2seg_tpu.config import config as jconfig
from u2seg_tpu.models.build import build_model as jbuild
from u2seg_tpu.models.fpn import ResNetFPN as JResNetFPN
from u2seg_torch import config as tconfig
from u2seg_torch.models.build import build_model
from u2seg_torch.models.dense_detector import DenseHead
from u2seg_torch.models.fpn import FPN
from u2seg_torch.weights import from_jax

torch.set_num_threads(1)

CASES = {"retinanet": ("RetinaNet", {"resnet.norm": "FrozenBN", "fpn.norm": ""}),
         "fcos": ("FCOS", {"fcos.head_norm": "GN"})}


def inputs():
    rng = np.random.RandomState(0)
    images = (rng.rand(2, 128, 128, 3) * 255).astype(np.float32)
    return images, np.array([[128, 128], [120, 100]], np.int32)


def run_both(case, dtype="float32", seed=1):
    meta, over = CASES[case]
    over = dict(over, compute_dtype=dtype)
    cfg_j, cfg_t = tiny(jconfig.Config(), meta, **over), tiny(tconfig.Config(), meta, **over)
    images, sizes = inputs()
    jm = jbuild(cfg_j)
    v = random_variables(jm, seed, jnp.asarray(images), jnp.asarray(sizes), train=False)
    ref = jax.jit(lambda v, x, s: jm.apply(v, x, s, train=False))(
        jnp_tree(v), jnp.asarray(images), jnp.asarray(sizes))
    model = port_from(v, build_model(cfg_t, device="cpu"))
    got = model(torch.from_numpy(images), torch.from_numpy(sizes))
    return dict(ref=ref, got=got, jm=jm, v=v, model=model, images=images)


@pytest.mark.parametrize("case", sorted(CASES))
def test_inference_matches_jax(case):
    r = run_both(case)
    n = same_detections(r["got"], r["ref"])
    assert n >= 20, f"only {n} detections: calibration failed"
    assert r["got"].boxes.shape == (2, 100, 4)


def test_bf16_matches_jax_at_amp_tolerance():
    r = run_both("retinanet", dtype="bfloat16", seed=4)
    jm, model = r["jm"], r["model"]
    ref_f = jax.jit(lambda v, x: jm.apply(v, x, method=lambda m, x: m.backbone(m.normalize(x))))(
        jnp_tree(r["v"]), jnp.asarray(r["images"]))
    with torch.no_grad():
        got_f = model.features(torch.from_numpy(r["images"]))
    assert sorted(got_f) == sorted(ref_f) == ["p3", "p4", "p5", "p6", "p7"]
    for k, ref in ref_f.items():
        want = jnp.float32 if k in ("p6", "p7") else jnp.bfloat16
        assert ref.dtype == want, k
        assert got_f[k].dtype == {jnp.float32: torch.float32,
                                  jnp.bfloat16: torch.bfloat16}[want], k
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(numpy_of(got_f[k].permute(0, 2, 3, 1)), ref, rtol=AMP_RTOL,
                                   atol=AMP_ATOL * float(np.abs(ref).max()), err_msg=k)
    assert int(np.asarray(r["ref"].valid).sum()) >= 20
    share = matched_share(r["got"], r["ref"])
    assert share >= 0.75, share


@pytest.mark.parametrize("fuse,dtype", [("avg", "float32"), ("sum", "float32"),
                                        ("avg", "bfloat16")])
def test_p6p7_fpn_matches_jax(fuse, dtype):
    cfg_j, cfg_t = tiny(jconfig.Config(), "RetinaNet"), tiny(tconfig.Config(), "RetinaNet")
    for cfg in (cfg_j, cfg_t):
        cfg.model.fpn.in_features = ("res3", "res4", "res5")
        cfg.model.fpn.top_block = "p6p7"
        cfg.model.fpn.fuse_type = fuse
        cfg.model.fpn.norm = ""
    jdt = jnp.dtype(dtype)
    jm = JResNetFPN(cfg_j.model.resnet, cfg_j.model.fpn, dtype=jdt)
    x = np.random.RandomState(3).randn(2, 96, 64, 3).astype(np.float32)
    v = random_variables(jm, 2, jnp.asarray(x))
    ref = jax.jit(lambda v, x: jm.apply(v, x.astype(jdt)))(jnp_tree(v), jnp.asarray(x))
    fpn = FPN(cfg_t.model.resnet, cfg_t.model.fpn)
    sd = from_jax({"backbone": v["params"]}, {"backbone": v.get("batch_stats", {})})
    fpn.load_state_dict({k[len("backbone."):]: t for k, t in sd.items()})
    assert "top_block.p6.weight" in fpn.state_dict()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    with torch.no_grad():
        got = fpn(xt)
    assert sorted(got) == sorted(ref) == ["p3", "p4", "p5", "p6", "p7"]
    assert got["p7"].shape[2:] == (1, 1)
    for k, r in ref.items():
        g = got[k].permute(0, 2, 3, 1)
        if dtype == "float32":
            close(g, r, name=k)
        else:
            assert g.dtype == (torch.float32 if k in ("p6", "p7") else torch.bfloat16), k
            r = np.asarray(r.astype(jnp.float32))
            np.testing.assert_allclose(numpy_of(g), r, rtol=AMP_RTOL,
                                       atol=AMP_ATOL * float(np.abs(r).max()), err_msg=k)


def test_dense_head_names_are_detectron2s():
    for meta, norm, step in (("RetinaNet", "", 2), ("FCOS", "GN", 3)):
        over = {"retinanet.head_norm": norm} if meta == "RetinaNet" else {"fcos.head_norm": norm}
        sd = build_model(tiny(tconfig.Config(), meta, **over), device="cpu").state_dict()
        for tower in ("cls_subnet", "bbox_subnet"):
            for i in range(4):
                assert f"head.{tower}.{step * i}.weight" in sd
                assert (f"head.{tower}.{step * i + 1}.weight" in sd) == bool(norm)
        assert ("head.ctrness.weight" in sd) == (meta == "FCOS")
        assert "backbone.top_block.p7.weight" in sd
        assert not any(k.startswith("backbone.fpn_lateral2") for k in sd)


def test_seeded_dense_heads_start_at_the_prior():
    model = build_model(tiny(tconfig.Config(), "RetinaNet"), device="cpu", seed=0)
    b = model.head.cls_score.bias
    assert torch.allclose(b, torch.full_like(b, -float(np.log(99.0))))
    assert abs(model.head.cls_score.weight.std().item() / 0.01 - 1) < 0.1
    assert abs(model.head.bbox_pred.weight.std().item() / 0.01 - 1) < 0.1


def test_head_shared_bn_is_a_later_slice():
    cfg = tiny(tconfig.Config(), "RetinaNet", **{"retinanet.head_norm": "BN",
                                                 "retinanet.head_shared_bn": True})
    with pytest.raises(NotImplementedError, match="rethinking_bn"):
        build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="rethinking_bn"):
        DenseHead(8, 3, 1, shared_levels_bn=True)


def test_a_maxpool_fpn_config_gets_the_p6p7_backbone():
    cfg = tiny(tconfig.Config(), "FCOS")
    assert cfg.model.fpn.top_block == "maxpool"
    model = build_model(cfg, device="cpu")
    assert model.cfg.fpn.top_block == "maxpool"           # the config is left as it was
    assert model.backbone.in_features == ("res3", "res4", "res5")
