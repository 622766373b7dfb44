"""TensorMask of the port against the JAX package on the CPU.

``swap_align2nat``: the port's two four-tap gathers against the JAX
package's einsums at lambda 1, 2 and 4 (windows that reach past the map
included; map sides that lambda does not divide) and against a brute-force
16-tap replica of the reference CUDA op; its gradient against JAX's.
Then the assignment rule, the GT window rasteriser, the head, and the whole
``TensorMask`` (losses and inference) at a tiny size, weights from the JAX
variable tree through ``weights.projects_from_jax``.

Tolerances (f32): ``swap_align2nat`` and the losses 1e-5 relative to the
largest reference value, the head and the inference outputs 1e-4;
assignments, classes, validity and the detections' anchors exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_zoo_parity import close, exact, jnp_tree, numpy_of, random_variables
from u2seg_tpu.projects import tensormask as JT
from u2seg_tpu.structures.instances import GtInstances as JGt
from u2seg_torch.projects import tensormask as PT
from u2seg_torch.structures.instances import GtInstances
from u2seg_torch.weights import projects_from_jax, seeded_init

torch.set_num_threads(1)


def close5(got, ref, name=""):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(numpy_of(got), ref, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(ref).max(initial=0.0)), 1e-30),
                               err_msg=name)


def nchw(x):
    return torch.from_numpy(np.array(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def brute_force_swap(x, lam, pad_val):
    """The reference op's 16 taps per output element, one by one (NHWC)."""
    n, hin, win, c = x.shape
    vin = int(round(np.sqrt(c)))
    x5 = x.reshape(n, hin, win, vin, vin)
    vout = lam * vin
    hout, wout = -(-hin // lam), -(-win // lam)

    def val(ni, yi, xi, vi, ui):
        if not (0 <= yi < hin and 0 <= xi < win and 0 <= vi < vin and 0 <= ui < vin):
            return pad_val
        return x5[ni, yi, xi, vi, ui]

    def taps(c):
        f = np.floor(c)
        return ((int(f), 1 - (c - f)), (int(np.ceil(c)), c - f))

    out = np.zeros((n, hout, wout, vout, vout), np.float64)
    for ni in range(n):
        for y in range(hout):
            for xq in range(wout):
                for v in range(vout):
                    for u in range(vout):
                        oy = y * lam + v - vout / 2.0 + 0.5
                        ox = xq * lam + u - vout / 2.0 + 0.5
                        ov = (v + 0.5) / lam - 0.5
                        ou = (u + 0.5) / lam - 0.5
                        out[ni, y, xq, v, u] = sum(
                            wy * wx * wv * wu * val(ni, yi, xi, vi, ui)
                            for yi, wy in taps(oy) for xi, wx in taps(ox)
                            for vi, wv in taps(ov) for ui, wu in taps(ou))
    return out.reshape(n, hout, wout, vout * vout)


@pytest.mark.parametrize("lam,shape", [(1, (2, 7, 9, 9)), (2, (1, 9, 7, 9)), (4, (1, 10, 13, 4)),
                                       (4, (2, 16, 12, 16))])
def test_swap_align2nat_matches_jax_einsum(lam, shape):
    x = np.random.RandomState(lam).randn(*shape).astype(np.float32)
    ref = JT.swap_align2nat(jnp.asarray(x), lam, pad_val=-6.0)
    got = PT.swap_align2nat(nchw(x), lam, pad_val=-6.0)
    assert got.shape[1:] == (ref.shape[3], ref.shape[1], ref.shape[2])
    close5(nhwc(got), ref)


@pytest.mark.parametrize("lam", [1, 2, 4])
def test_swap_align2nat_matches_the_16_tap_oracle(lam):
    x = np.random.RandomState(10 + lam).randn(1, 6, 5, 9).astype(np.float32)
    close5(nhwc(PT.swap_align2nat(nchw(x), lam, pad_val=-3.0)), brute_force_swap(x, lam, -3.0))


@pytest.mark.parametrize("lam", [1, 2, 4])
def test_swap_align2nat_gradient_matches_jax(lam):
    rng = np.random.RandomState(20 + lam)
    x = rng.randn(2, 8, 7, 9).astype(np.float32)
    ref_y = JT.swap_align2nat(jnp.asarray(x), lam)
    cot = rng.randn(*ref_y.shape).astype(np.float32)
    ref = jax.grad(lambda a: jnp.sum(JT.swap_align2nat(a, lam) * cot))(jnp.asarray(x))
    tx = nchw(x).requires_grad_()
    (PT.swap_align2nat(tx, lam) * nchw(cot)).sum().backward()
    close5(nhwc(tx.grad), ref)
    assert isinstance(PT.SwapAlign2Nat(lam)(nchw(x)), torch.Tensor)


def _gt(rng, b, g, p=16, boxes=None):
    if boxes is None:
        xy = rng.rand(b, g, 2) * 40
        boxes = np.concatenate([xy, xy + 4 + rng.rand(b, g, 2) * 20], -1)
    boxes = np.asarray(boxes, np.float32)
    classes = rng.randint(0, 5, (b, g)).astype(np.int32)
    valid = np.ones((b, g), bool)
    valid[:, -1] = False
    masks = rng.rand(b, g, p, p).astype(np.float32)
    return ((boxes, classes, valid, masks),
            JGt(*(jnp.asarray(a) for a in (boxes, classes, valid, masks))),
            GtInstances(*(torch.from_numpy(a) for a in (boxes, classes, valid, masks))))


def test_assignment_rule_matches_jax():
    rng = np.random.RandomState(3)
    anchors = np.concatenate([rng.rand(300, 2) * 60, np.zeros((300, 2))], 1)
    anchors[:, 2:] = anchors[:, :2] + rng.choice([12.0, 20.0, 24.0, 40.0], (300, 1))
    anchors = anchors.astype(np.float32)
    units = rng.choice([4.0, 8.0], 300).astype(np.float32)
    # GT boxes that some anchors contain, centred near them
    centres = anchors[rng.choice(300, (2, 6))][..., :2] + 6
    _, jgt, pgt = _gt(rng, 2, 6, boxes=np.concatenate([centres - 3, centres + 3], -1))
    rm, rf = jax.vmap(lambda gt: JT.tensormask_assign(gt, jnp.asarray(anchors), jnp.asarray(units),
                                                      12.0))(jgt)
    gm, gf = PT.tensormask_assign(pgt, torch.from_numpy(anchors), torch.from_numpy(units), 12.0)
    exact(gf, rf)
    assert int(np.asarray(rf).sum()) > 0
    exact(torch.where(gf, gm, 0), np.where(np.asarray(rf), np.asarray(rm), 0))


def test_crop_gt_mask_matches_jax():
    rng = np.random.RandomState(4)
    patch = rng.rand(7, 16, 16).astype(np.float32)
    gtb = np.concatenate([rng.rand(7, 2) * 20, rng.rand(7, 2) * 20 + 25], 1).astype(np.float32)
    anc = (gtb + rng.randn(7, 4) * 6).astype(np.float32)
    for size in (3, 11, 20):
        ref = jax.vmap(lambda p, g, a: JT._crop_gt_mask(p, g, a, size))(
            jnp.asarray(patch), jnp.asarray(gtb), jnp.asarray(anc))
        exact(PT._crop_gt_mask(torch.from_numpy(patch), torch.from_numpy(gtb),
                               torch.from_numpy(anc), size), ref)


def _cfg(align, bipyramid, **kw):
    over = dict(num_classes=5, in_features=("p2", "p3"), num_convs=1, cls_channels=8,
                bbox_channels=8, mask_channels=8, mask_sizes=(3, 5), topk_candidates=50,
                max_detections=10, max_fg=8, mask_out_size=14, align_on=align,
                bipyramid_on=bipyramid)
    over.update(kw)
    return JT.TensorMaskConfig(**over), PT.TensorMaskConfig(**over)


def _feats(rng, b=2, c=6):
    f = {"p2": rng.randn(b, 16, 20, c).astype(np.float32),
         "p3": rng.randn(b, 8, 10, c).astype(np.float32)}
    return f, {k: jnp.asarray(v) for k, v in f.items()}, {k: nchw(v) for k, v in f.items()}


def _model(align, bipyramid, rng, gt):
    jcfg, pcfg = _cfg(align, bipyramid)
    f, jf, pf = _feats(rng)
    sizes = np.array([[64, 80], [60, 72]], np.int32)
    jm = JT.TensorMask(jcfg)
    v = random_variables(jm, 5, jf, jnp.asarray(sizes), gt=gt, train=True)
    pm = PT.TensorMask(pcfg, 6)
    pm.load_state_dict(projects_from_jax(pm, v["params"]))
    return jm, v, pm, jf, pf, sizes


@pytest.mark.parametrize("align,bipyramid", [(True, True), (False, False)])
def test_tensormask_head_matches_jax(align, bipyramid):
    rng = np.random.RandomState(6)
    jcfg, pcfg = _cfg(align, bipyramid)
    f, jf, pf = _feats(rng)
    jh = JT.TensorMaskHead(jcfg)
    v = random_variables(jh, 7, [jf["p2"], jf["p3"]])
    ph = PT.TensorMaskHead(pcfg, 6)
    ph.load_state_dict(projects_from_jax(ph, v["params"]))
    rl, rd, rm = jh.apply(jnp_tree(v), [jf["p2"], jf["p3"]])
    gl, gd, gm = ph([pf["p2"], pf["p3"]])
    for g, r in zip(gl + gd, list(rl) + list(rd)):
        close(nhwc(g), r)
    for grow, rrow in zip(gm, rm):
        for g, r in zip(grow, rrow):
            close(nhwc(g), r)


@pytest.mark.parametrize("align,bipyramid", [(True, True), (False, False)])
def test_tensormask_losses_and_inference_match_jax(align, bipyramid):
    rng = np.random.RandomState(8)
    # each GT inside a p2 or p3 anchor, centred on it: foreground anchors exist
    boxes = np.array([[[9.0, 9.0, 19.0, 19.0], [30.0, 2.0, 42.0, 14.0], [17.0, 17.0, 39.0, 39.0],
                       [0.0, 0.0, 1.0, 1.0]],
                      [[41.0, 25.0, 51.0, 35.0], [4.0, 36.0, 20.0, 52.0], [10.0, 8.0, 16.0, 14.0],
                       [0.0, 0.0, 1.0, 1.0]]], np.float32)
    _, jgt, pgt = _gt(rng, 2, 4, boxes=boxes)
    jm, v, pm, jf, pf, sizes = _model(align, bipyramid, rng, jgt)
    ref = jm.apply(jnp_tree(v), jf, jnp.asarray(sizes), gt=jgt, train=True)
    got = pm(pf, torch.from_numpy(sizes), gt=pgt, train=True)
    assert set(got) == set(ref) == {"loss_cls", "loss_box_reg", "loss_mask"}
    assert float(ref["loss_mask"]) > 0
    for k in ref:
        close(got[k], ref[k], name=k)
    sum(got.values()).backward()
    assert all(torch.isfinite(p.grad).all() for p in pm.parameters() if p.grad is not None)

    ref = jm.apply(jnp_tree(v), jf, jnp.asarray(sizes), train=False)
    with torch.no_grad():
        got = pm(pf, torch.from_numpy(sizes))
    assert int(np.asarray(ref["valid"]).sum()) > 0
    for k in ("valid", "classes", "mask_src_boxes"):
        exact(got[k], ref[k], name=k)
    for k in ("boxes", "scores", "mask_patches"):
        close(got[k], ref[k], name=k)


def test_tensormask_seeded_init_follows_the_jax_initializers():
    cfg = PT.TensorMaskConfig(num_classes=5, in_features=("p2", "p3"), num_convs=1)
    m = seeded_init(PT.TensorMask(cfg, 64), seed=0)
    w = m.head.cls_subnet0.weight.detach()
    assert abs(float(w.std()) - 0.01) < 1e-3
    assert float(m.head.cls_subnet0.bias.detach().abs().max()) == 0
    np.testing.assert_allclose(m.head.cls_score.bias.detach().numpy(), -np.log(99.0), rtol=1e-6)
