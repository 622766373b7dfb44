"""DensePose (chart) of the port against the JAX package on the CPU: the
loss geometry (chart sampling, point remapping, the part raster's
resampling), the ROI head and predictor (plain and both UV confidence
types), the chart losses, IUV inference, ROI selection and GT gathering,
and ``DensePoseHeads`` end to end (losses, gradients, inference) over
numpy-drawn FPN maps. Weights come from the JAX variable trees through
``weights.projects_from_jax``.

Tolerances (f32): sampling, geometry and losses 1e-5 relative to the
largest reference value, the conv head's outputs and gradients 1e-4;
indices, labels and rasters exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_zoo_parity import close, exact, jnp_tree, numpy_of, random_variables
from u2seg_tpu.projects import densepose as JD
from u2seg_torch.projects import densepose as PD
from u2seg_torch.weights import projects_from_jax

torch.set_num_threads(1)


def close5(got, ref, name=""):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(numpy_of(got), ref, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(ref).max(initial=0.0)), 1e-30),
                               err_msg=name)


def t(x):
    return torch.from_numpy(np.array(x))


def nchw(x):
    return t(np.asarray(x).transpose(0, 3, 1, 2))


def nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def boxes(rng, r, lo=0.0, span=60.0):
    xy = rng.rand(r, 2) * span + lo
    return np.concatenate([xy, xy + 8 + rng.rand(r, 2) * 40], 1).astype(np.float32)


def points(rng, r, p, k=25):
    arrs = (rng.uniform(-0.05, 1.05, (r, p, 2)).astype(np.float32),
            rng.randint(0, k, (r, p)).astype(np.int32), rng.rand(r, p).astype(np.float32),
            rng.rand(r, p).astype(np.float32), rng.rand(r, p) > 0.2)
    return (JD.DensePosePoints(*(jnp.asarray(a) for a in arrs)),
            PD.DensePosePoints(*(t(a) for a in arrs)))


def test_chart_point_sample_matches_jax():
    rng = np.random.RandomState(0)
    maps = rng.randn(4, 12, 12, 7).astype(np.float32)
    pts = rng.uniform(-0.1, 1.1, (4, 30, 2)).astype(np.float32)
    pts[0, :4] = [[0, 0], [1, 1], [0.5, 1.0], [1.0, 0.25]]
    close5(PD.chart_point_sample(nchw(maps), t(pts)),
           JD.chart_point_sample(jnp.asarray(maps), jnp.asarray(pts)))


def test_remap_and_resample_match_jax():
    rng = np.random.RandomState(1)
    gtb, prop = boxes(rng, 6), boxes(rng, 6)
    prop[:3] = gtb[:3] + rng.randn(3, 4).astype(np.float32) * 3
    xy = rng.rand(6, 9, 2).astype(np.float32)
    rc, ri = JD.remap_points_to_proposals(jnp.asarray(xy), jnp.asarray(gtb), jnp.asarray(prop))
    gc, gi = PD.remap_points_to_proposals(t(xy), t(gtb), t(prop))
    close5(gc, rc)
    exact(gi, ri)
    segm = rng.randint(0, 15, (6, 32, 32)).astype(np.uint8)
    for size, binarize in ((28, True), (17, False)):
        ref = JD.resample_coarse_segm_gt(jnp.asarray(segm), jnp.asarray(gtb), jnp.asarray(prop),
                                         size, binarize)
        exact(PD.resample_coarse_segm_gt(t(segm), t(gtb), t(prop), size, binarize), ref)


def _roi_head(conf, seed, cin=8, hw=7):
    cfg_kw = dict(num_stacked_convs=2, conv_head_dim=16, uv_confidence=conf)
    jm = JD.DensePoseROIHead(JD.DensePoseConfig(**cfg_kw))
    x = np.random.RandomState(seed).randn(3, hw, hw, cin).astype(np.float32)
    v = random_variables(jm, seed, jnp.asarray(x))
    pm = PD.DensePoseROIHead(PD.DensePoseConfig(**cfg_kw), cin)
    pm.load_state_dict(projects_from_jax(pm, v["params"]))
    return jm, v, pm, x


@pytest.mark.parametrize("conf", ["", "iid_iso", "indep_aniso"])
def test_roi_head_and_chart_losses_match_jax(conf):
    jm, v, pm, x = _roi_head(conf, 2)
    ref = jm.apply(jnp_tree(v), jnp.asarray(x))
    got = pm(nchw(x))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape[2] == 7 * 4
        close(nhwc(got[k]), ref[k], name=k)
    # the losses on the same maps (the JAX outputs, NCHW for the port)
    rng = np.random.RandomState(3)
    jp, pp = points(rng, 3, 11)
    s = ref["coarse_segm"].shape[1]
    coarse_gt = rng.randint(0, 2, (3, s, s)).astype(np.int32)
    roi_valid = np.array([True, True, False])
    cfg = JD.DensePoseConfig(uv_confidence=conf)
    rl = JD.densepose_chart_losses(ref, jp, jnp.asarray(coarse_gt), jnp.asarray(roi_valid), cfg)
    gl = PD.densepose_chart_losses({k: nchw(a) for k, a in ref.items()}, pp, t(coarse_gt),
                                   t(roi_valid), PD.DensePoseConfig(uv_confidence=conf))
    assert set(gl) == set(rl)
    for k in rl:
        close5(gl[k], rl[k], name=k)


def test_chart_inference_and_point_errors_match_jax():
    jm, v, pm, x = _roi_head("", 4)
    ref_out = jm.apply(jnp_tree(v), jnp.asarray(x))
    outs = {k: nchw(a) for k, a in ref_out.items()}
    for g, r in zip(PD.densepose_chart_inference(outs), JD.densepose_chart_inference(ref_out)):
        close5(g, r) if g.is_floating_point() else exact(g, r)
    jp, pp = points(np.random.RandomState(5), 3, 13)
    rm = JD.point_iuv_errors(ref_out, jp)
    gm = PD.point_iuv_errors(outs, pp)
    for k in rm:
        close5(gm[k], rm[k], name=k)


def test_select_rois_and_gather_gt_match_jax():
    rng = np.random.RandomState(6)
    b, s, g, cap = 2, 12, 4, 5
    is_fg = rng.rand(b, s) > 0.4
    gt_idx = rng.randint(0, g, (b, s)).astype(np.int32)
    dp_valid = rng.rand(b, g) > 0.3
    ri, rl = JD.select_densepose_rois(jnp.asarray(is_fg), jnp.asarray(gt_idx),
                                      jnp.asarray(dp_valid), cap)
    gi, gl = PD.select_densepose_rois(t(is_fg), t(gt_idx), t(dp_valid), cap)
    exact(gi, ri)
    exact(gl, rl)
    gt = {"dp_xy": rng.rand(b, g, 6, 2).astype(np.float32),
          "dp_i": rng.randint(0, 25, (b, g, 6)).astype(np.int32),
          "dp_u": rng.rand(b, g, 6).astype(np.float32), "dp_v": rng.rand(b, g, 6).astype(np.float32),
          "dp_point_valid": rng.rand(b, g, 6) > 0.5,
          "dp_segm": rng.randint(0, 15, (b, g, 8, 8)).astype(np.uint8)}
    gtb = rng.rand(b, g, 4).astype(np.float32)
    roi_gt = rng.randint(0, g, (b, cap)).astype(np.int32)
    ref = JD.gather_densepose_gt_for_rois({k: jnp.asarray(a) for k, a in gt.items()},
                                          jnp.asarray(gtb), jnp.asarray(roi_gt))
    got = PD.gather_densepose_gt_for_rois({k: t(a) for k, a in gt.items()}, t(gtb), t(roi_gt))
    assert set(got) == set(ref)
    for k in ref:
        exact(got[k], ref[k], name=k)


def _feats(rng, b=2, c=8):
    f = {f"p{i + 2}": rng.randn(b, 64 // 2 ** i, 64 // 2 ** i, c).astype(np.float32)
         for i in range(4)}
    return {k: jnp.asarray(a) for k, a in f.items()}, {k: nchw(a) for k, a in f.items()}


@pytest.mark.parametrize("conf", ["", "indep_aniso"])
def test_densepose_heads_end_to_end_match_jax(conf):
    rng = np.random.RandomState(7)
    b, g, p, sg, cap, res = 2, 3, 6, 32, 4, 7
    cfg_kw = dict(num_stacked_convs=2, conv_head_dim=16, uv_confidence=conf)
    jf, pf = _feats(rng)
    gtb = rng.rand(b, g, 4).astype(np.float32) * 120
    gtb[..., 2:] = gtb[..., :2] + 60.0
    gt = {"dp_xy": rng.rand(b, g, p, 2).astype(np.float32),
          "dp_i": rng.randint(1, 25, (b, g, p)).astype(np.int32),
          "dp_u": rng.rand(b, g, p).astype(np.float32), "dp_v": rng.rand(b, g, p).astype(np.float32),
          "dp_point_valid": np.ones((b, g, p), bool),
          "dp_segm": rng.randint(0, 15, (b, g, sg, sg)).astype(np.uint8),
          "dp_valid": np.array([[True, True, False], [True, False, False]])}
    prop = np.concatenate([gtb + 4.0, np.tile([[[0.0, 0.0, 30.0, 30.0]]], (b, 3, 1))], 1)
    prop = prop.astype(np.float32)
    is_fg = np.array([[1, 1, 1, 0, 0, 0]] * b, bool)
    gt_idx = np.tile(np.array([0, 1, 2, 0, 0, 0], np.int32), (b, 1))

    ji, jl = JD.select_densepose_rois(jnp.asarray(is_fg), jnp.asarray(gt_idx),
                                      jnp.asarray(gt["dp_valid"]), cap)
    rb = jnp.take_along_axis(jnp.asarray(prop), ji[..., None], axis=1)
    jgt = JD.gather_densepose_gt_for_rois(
        {k: jnp.asarray(a) for k, a in gt.items()}, jnp.asarray(gtb),
        jnp.take_along_axis(jnp.asarray(gt_idx), ji, axis=1))
    jm = JD.DensePoseHeads(JD.DensePoseConfig(**cfg_kw), pooler_resolution=res)
    v = random_variables(jm, 8, jf, rb, train=True, gt=jgt, roi_live=jl)

    def loss(params):
        out = jm.apply({"params": params}, jf, rb, train=True, gt=jgt, roi_live=jl)
        return sum(out.values()), out

    (_, ref), grads = jax.value_and_grad(loss, has_aux=True)(jnp_tree(v["params"]))
    pm = PD.DensePoseHeads(PD.DensePoseConfig(**cfg_kw), 8, pooler_resolution=res)
    pm.load_state_dict(projects_from_jax(pm, v["params"]))
    pi, pl = PD.select_densepose_rois(t(is_fg), t(gt_idx), t(gt["dp_valid"]), cap)
    pb = torch.gather(t(prop), 1, pi.long()[..., None].expand(-1, -1, 4))
    pgt = PD.gather_densepose_gt_for_rois({k: t(a) for k, a in gt.items()}, t(gtb),
                                          torch.gather(t(gt_idx), 1, pi.long()))
    got = pm(pf, pb, train=True, gt=pgt, roi_live=pl)
    assert set(got) == set(ref)
    for k in ref:
        close5(got[k], ref[k], name=k)
    sum(got.values()).backward()
    dp = grads["densepose"]
    close(pm.densepose.head.body_conv_fcn1.weight.grad.permute(2, 3, 1, 0).numpy(),
          dp["head"]["body_conv_fcn1"]["kernel"], name="d body_conv_fcn1")
    close(pm.densepose.predictor.u_lowres.bias.grad, dp["predictor"]["u_lowres"]["bias"],
          name="d u_lowres bias")

    ref = jm.apply(jnp_tree(v), jf, rb, train=False)
    with torch.no_grad():
        got = pm(pf, pb)
    for k in ref:
        assert got[k].shape == (b, cap, ref[k].shape[-1], 4 * res, 4 * res)
        close(got[k].permute(0, 1, 3, 4, 2), ref[k], name=k)
