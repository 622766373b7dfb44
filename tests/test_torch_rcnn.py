"""The R-CNN meta-architectures of u2seg_torch vs the JAX package, inference
on the CPU: GeneralizedRCNN as Faster, Mask (with a 2-conv GN box head over a
GN trunk and FPN), Cascade Mask and Keypoint R-CNN, ProposalNetwork and
SemanticSegmentor; ``from_jax`` for every meta-architecture; the bf16 runs.

Each case jits the JAX module once on b=2 numpy images (128x128 and a
120x100 valid region) with a variable tree drawn from numpy
(``torch_zoo_parity.random_variables``, whose kernel scale also calibrates
the classifiers to detect), loads the same numbers into the port, and runs
both with ``pooler_impl="gather"``.

Tolerances: boxes, scores and keypoint x/y rtol 1e-4 with atol 1e-4 *
max|ref|; classes and validity exact; mask logits rtol 1e-3 with atol 1e-3 *
max|ref| (downstream of the refined boxes, whose f32 rounding they amplify
at the ROIAlign sample positions; measured <= 3e-4 of max); sem-seg logits
1e-4. bf16 (Cascade Mask R-CNN): the levels at the AMP tolerance (rtol 0.05,
atol 0.03 * max|ref|) and at least 75% of the JAX detections found by the
port (same class, box sides within 1 px; measured 87.5%: the scores of
seeded heads lie close together, and a near tie at the top-20 cut or in the
NMS order resolves the other way in bf16). ProposalNetwork and
SemanticSegmentor compute in f32 in both packages whatever
``compute_dtype`` says, so the bf16 ProposalNetwork is held at the f32
tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_zoo_parity import (AMP_ATOL, AMP_RTOL, close, exact, jnp_tree,
                              matched_share, numpy_of, port_from, random_variables,
                              same_detections, tiny)
from u2seg_tpu.config import config as jconfig
from u2seg_tpu.models.build import build_model as jbuild
from u2seg_torch import config as tconfig
from u2seg_torch.models.build import build_model
from u2seg_torch.weights import from_jax

torch.set_num_threads(1)

CASES = {
    "faster": ("GeneralizedRCNN", {
        "roi_heads.name": "StandardROIHeads", "mask_on": False,
        "roi_heads.cls_agnostic_bbox_reg": False, "resnet.norm": "FrozenBN",
        "fpn.norm": ""}),
    "mask_gn": ("GeneralizedRCNN", {
        "roi_heads.name": "StandardROIHeads", "resnet.norm": "GN",
        "resnet.stride_in_1x1": False, "fpn.norm": "GN",
        "roi_heads.box_head.num_conv": 2, "roi_heads.box_head.num_fc": 1,
        "roi_heads.box_head.norm": "GN"}),
    "cascade_mask": ("GeneralizedRCNN", {"roi_heads.name": "CascadeROIHeads"}),
    "keypoint": ("GeneralizedRCNN", {
        "roi_heads.name": "StandardROIHeads", "mask_on": False, "keypoint_on": True,
        "roi_heads.num_classes": 1, "resnet.norm": "FrozenBN", "fpn.norm": ""}),
    "rpn": ("ProposalNetwork", {"fpn.norm": ""}),
    "sem": ("SemanticSegmentor", {"resnet.norm": "FrozenBN"}),
}


def inputs():
    rng = np.random.RandomState(0)
    images = (rng.rand(2, 128, 128, 3) * 255).astype(np.float32)
    sizes = np.array([[128, 128], [120, 100]], np.int32)
    return images, sizes


def run_both(case, dtype="float32", seed=1):
    meta, over = CASES[case]
    over = dict(over, compute_dtype=dtype)
    cfg_j = tiny(jconfig.Config(), meta, **over)
    cfg_t = tiny(tconfig.Config(), meta, **over)
    images, sizes = inputs()
    jm = jbuild(cfg_j)
    v = random_variables(jm, seed, jnp.asarray(images), jnp.asarray(sizes), train=False)
    ref = jax.jit(lambda v, x, s: jm.apply(v, x, s, train=False))(
        jnp_tree(v), jnp.asarray(images), jnp.asarray(sizes))
    model = port_from(v, build_model(cfg_t, device="cpu"))
    got = model(torch.from_numpy(images), torch.from_numpy(sizes))
    return dict(ref=ref, got=got, jm=jm, v=v, model=model, images=images)


@pytest.fixture(scope="module")
def f32():
    return {}


def outputs(cache, case):
    if case not in cache:
        cache[case] = run_both(case)
    return cache[case]


@pytest.mark.parametrize("case", ["faster", "mask_gn", "cascade_mask", "keypoint"])
def test_generalized_rcnn_inference_matches_jax(f32, case):
    r = outputs(f32, case)
    n = same_detections(r["got"], r["ref"])
    assert n >= 10, f"only {n} detections: the test would not see decoding and NMS"
    if r["ref"].mask_logits is not None:
        ref = np.asarray(r["ref"].mask_logits)
        np.testing.assert_allclose(numpy_of(r["got"].mask_logits), ref, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(ref).max()))
    if case == "keypoint":
        kp_ref, kp = np.asarray(r["ref"].keypoints), numpy_of(r["got"].keypoints)
        assert kp.shape == kp_ref.shape == (2, 20, 17, 4)
        close(kp[..., 2:], kp_ref[..., 2:], name="keypoint logit, prob")


def test_proposal_network_matches_jax(f32):
    r = outputs(f32, "rpn")
    n = same_detections(r["got"], r["ref"])
    assert n == 200
    assert int(numpy_of(r["got"].classes).max()) == 0


def test_semantic_segmentor_matches_jax(f32):
    r = outputs(f32, "sem")
    assert r["got"].shape == (2, 32, 32, 5)
    close(r["got"], r["ref"], name="sem-seg logits")


@pytest.mark.parametrize("case", ["faster", "keypoint"])
def test_module_names_are_detectron2s(f32, case):
    sd = outputs(f32, case)["model"].state_dict()
    assert "roi_heads.box_head.fc1.weight" in sd
    assert "roi_heads.box_predictor.cls_score.weight" in sd
    if case == "keypoint":
        for k in ("roi_heads.keypoint_head.conv_fcn1.weight",
                  "roi_heads.keypoint_head.conv_fcn2.bias",
                  "roi_heads.keypoint_head.score_lowres.weight"):
            assert k in sd, k
        assert sd["roi_heads.keypoint_head.score_lowres.weight"].shape == (16, 17, 4, 4)


def test_box_head_convs_carry_their_norm(f32):
    sd = outputs(f32, "mask_gn")["model"].state_dict()
    for i in (1, 2):
        assert f"roi_heads.box_head.conv{i}.norm.weight" in sd
        assert f"roi_heads.box_head.conv{i}.bias" not in sd
    # fc1 reads the 2nd conv's 32 channels at 7 x 7 in d2's NCHW order
    assert sd["roi_heads.box_head.fc1.weight"].shape == (64, 32 * 49)


# ---------------------------------------------------------------------------
# from_jax: every meta-architecture, strictly
# ---------------------------------------------------------------------------

STRICT = {
    "PanopticFPN": {},
    "GeneralizedRCNN": {"roi_heads.name": "StandardROIHeads", "keypoint_on": True,
                        "roi_heads.box_head.num_conv": 2, "roi_heads.box_head.norm": "BN"},
    "ProposalNetwork": {},
    "SemanticSegmentor": {},
    "RetinaNet": {"retinanet.head_norm": "GN"},
    "FCOS": {"fcos.head_norm": "BN"},
}


@pytest.mark.parametrize("meta", sorted(STRICT))
def test_from_jax_loads_strictly(meta):
    cfg_j = tiny(jconfig.Config(), meta, **STRICT[meta])
    cfg_t = tiny(tconfig.Config(), meta, **STRICT[meta])
    x, s = jnp.zeros((1, 64, 64, 3)), jnp.array([[64, 64]], jnp.int32)
    v = random_variables(jbuild(cfg_j), 3, x, s, train=False)
    sd = from_jax(v["params"], v.get("batch_stats", {}))
    model = build_model(cfg_t, device="cpu")
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not missing and not unexpected, (missing, unexpected)
    n_leaves = len(jax.tree_util.tree_leaves(v))
    assert len(sd) == n_leaves, (len(sd), n_leaves)   # every JAX number lands once


def test_a_normed_mask_head_departs_from_the_jax_package():
    """The JAX mask head takes ``norm`` and never applies it (its convs keep
    their bias). The port applies it as detectron2 does, so the only keys
    that differ are the mask convs' norms and biases."""
    over = {"roi_heads.name": "StandardROIHeads", "roi_heads.mask_head.norm": "GN"}
    cfg_j = tiny(jconfig.Config(), **over)
    cfg_t = tiny(tconfig.Config(), **over)
    v = random_variables(jbuild(cfg_j), 4, jnp.zeros((1, 64, 64, 3)),
                         jnp.array([[64, 64]], jnp.int32), train=False)
    assert not any("Norm" in k for k in v["params"]["roi_heads"]["mask_head"])
    missing, unexpected = build_model(cfg_t, device="cpu").load_state_dict(
        from_jax(v["params"], v.get("batch_stats", {})), strict=False)
    assert sorted(missing) == sorted(f"roi_heads.mask_head.mask_fcn{i}.norm.{p}"
                                     for i in range(1, 5) for p in ("weight", "bias"))
    assert sorted(unexpected) == sorted(f"roi_heads.mask_head.mask_fcn{i}.bias"
                                        for i in range(1, 5))


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------

def test_mask_rcnn_bf16_matches_jax_at_amp_tolerance():
    r = run_both("cascade_mask", dtype="bfloat16", seed=5)
    jm, model = r["jm"], r["model"]
    images = r["images"]
    ref_f = jax.jit(lambda v, x: jm.apply(v, x, method=lambda m, x: m.backbone(m.normalize(x))))(
        jnp_tree(r["v"]), jnp.asarray(images))
    with torch.no_grad():
        got_f = model.features(torch.from_numpy(images))
    for k, ref in ref_f.items():
        g = got_f[k].permute(0, 2, 3, 1)
        assert g.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16, k
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(numpy_of(g), ref, rtol=AMP_RTOL,
                                   atol=AMP_ATOL * float(np.abs(ref).max()), err_msg=k)
    share = matched_share(r["got"], r["ref"])
    assert int(np.asarray(r["ref"].valid).sum()) >= 10
    assert share >= 0.75, share          # measured 0.875: near ties at the top-20 cut


def test_proposal_network_ignores_bf16_as_the_jax_package_does():
    same_detections(**{k: v for k, v in run_both("rpn", dtype="bfloat16", seed=6).items()
                       if k in ("got", "ref")})


def test_semantic_segmentor_computes_in_f32_under_bf16():
    cfg = tiny(tconfig.Config(), "SemanticSegmentor", compute_dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    images, sizes = inputs()
    feats = model.features(torch.from_numpy(images))
    assert {v.dtype for v in feats.values()} == {torch.float32}
    assert model(torch.from_numpy(images), torch.from_numpy(sizes)).dtype == torch.float32
