"""The port's deformable convs, ASPP, DeepLab and Panoptic-DeepLab heads and
the rethinking-BN pieces against the JAX package on the CPU.

Each JAX module's variables are drawn from numpy
(``torch_zoo_parity.random_variables``) and loaded into the port through
``weights.projects_from_jax`` with a strict ``load_state_dict``; NHWC inputs
on the JAX side, the same numbers NCHW on the port's.

Tolerances (f32): outputs and losses rtol 1e-4 with atol 1e-4 * max|ref|;
the deformable conv's gradients (features, offsets, mask, weight) 1e-4 *
max|ref|; train-mode BN statistics 1e-4; grouping ids and panoptic maps
exact; ShuffleBN's round trip exact and its output 1e-6 against the same
arithmetic in one process.
"""
import functools
import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_zoo_parity import close, jnp_tree, port_from, random_variables, tiny
from u2seg_tpu.config import config as jconfig
from u2seg_tpu.models.build import build_model as jbuild
from u2seg_tpu.ops import aspp as JA
from u2seg_tpu.ops import deform_conv as JD
from u2seg_tpu.ops.norms import get_norm as jget_norm
from u2seg_tpu.projects import deeplab as JDL
from u2seg_tpu.projects import panoptic_deeplab as JPD
from u2seg_tpu.projects import rethinking_bn as JR
from u2seg_tpu.structures.instances import GtInstances as JGt
from u2seg_torch import config as tconfig
from u2seg_torch.models.build import build_model
from u2seg_torch.ops import aspp as PA
from u2seg_torch.ops import deform_conv as PD
from u2seg_torch.ops.norms import BatchNorm2d, get_norm
from u2seg_torch.projects import deeplab as PDL
from u2seg_torch.projects import panoptic_deeplab as PPD
from u2seg_torch.projects import rethinking_bn as PR
from u2seg_torch.structures.instances import GtInstances
from u2seg_torch.weights import from_jax, projects_from_jax, seeded_init

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_shufflebn_worker.py")
sys.path.insert(0, os.path.join(ROOT, "tests"))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def port(module, v):
    module.load_state_dict(projects_from_jax(module, v["params"], v.get("batch_stats", {})))
    return module


def apply_train(jm, v, *args, **kw):
    out, new = jm.apply(jnp_tree(v), *args, train=True, mutable=["batch_stats"], **kw)
    return out, new.get("batch_stats", {})


# ---------------------------------------------------------------------------
# Deformable convolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride,padding,dilation,modulated", [
    (1, 1, 1, False), (2, 1, 1, True), (1, 2, 2, True), (1, 0, 1, False)])
def test_deform_conv2d_forward_and_gradients_match_jax(stride, padding, dilation, modulated):
    rng = np.random.RandomState(stride * 10 + padding + dilation)
    b, h, w, cin, cout, k = 2, 9, 11, 5, 6, 3
    ho = (h + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    x = rng.randn(b, h, w, cin).astype(np.float32)
    off = (rng.randn(b, ho, wo, 2 * k * k) * 2.5).astype(np.float32)     # many taps leave the map
    wt = (rng.randn(k, k, cin, cout) * 0.3).astype(np.float32)
    mask = rng.rand(b, ho, wo, k * k).astype(np.float32) * 2 if modulated else None
    bias = rng.randn(cout).astype(np.float32) if modulated else None
    cot = rng.randn(b, ho, wo, cout).astype(np.float32)

    def jf(x, off, wt, mask):
        y = JD.deform_conv2d(x, off, wt, stride, padding, dilation, mask=mask,
                             bias=None if bias is None else jnp.asarray(bias))
        return jnp.sum(y * cot), y

    args = [jnp.asarray(a) for a in (x, off, wt)] + [None if mask is None else jnp.asarray(mask)]
    argnums = (0, 1, 2, 3) if modulated else (0, 1, 2)
    (_, ref), grads = jax.value_and_grad(jf, argnums=argnums, has_aux=True)(*args)
    tx, toff = nchw(x).requires_grad_(), nchw(off).requires_grad_()
    twt = torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()).requires_grad_()
    tmask = nchw(mask).requires_grad_() if modulated else None
    y = PD.deform_conv2d(tx, toff, twt, stride, padding, dilation, mask=tmask,
                         bias=None if bias is None else torch.from_numpy(bias))
    (y * nchw(cot)).sum().backward()
    close(nhwc(y), ref, name="y")
    close(nhwc(tx.grad), grads[0], name="dx")
    close(nhwc(toff.grad), grads[1], name="doffsets")
    close(twt.grad.permute(2, 3, 1, 0).numpy(), grads[2], name="dweight")
    if modulated:
        close(nhwc(tmask.grad), grads[3], name="dmask")


@pytest.mark.parametrize("cls", ["DeformConv", "ModulatedDeformConv"])
def test_deform_conv_modules_match_jax(cls):
    rng = np.random.RandomState(len(cls))
    x = rng.randn(2, 10, 12, 6).astype(np.float32)
    jm = getattr(JD, cls)(features=7)
    v = random_variables(jm, 3, jnp.asarray(x))
    ref = jm.apply(jnp_tree(v), jnp.asarray(x))
    tm = port(getattr(PD, cls)(6, 7), v)
    close(nhwc(tm(nchw(x))), ref)


def test_zero_offsets_and_unit_masks_are_a_plain_conv():
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(2, 5, 8, 9).astype(np.float32))
    m = seeded_init(PD.ModulatedDeformConv(5, 4), seed=1)
    assert float(m.offset_mask_conv.weight.abs().max()) == 0     # zero init
    # the zero branch gives masks 2 * sigmoid(0) = 1
    ref = torch.nn.functional.conv2d(x, m.weight, m.bias, padding=1)
    close(m(x), ref.detach().numpy())


# ---------------------------------------------------------------------------
# ASPP and the DeepLab heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm,pool", [("GN", None), ("GN", (2, 3)), ("BN", None), ("", (4, 6))])
def test_aspp_matches_jax(norm, pool):
    rng = np.random.RandomState(len(norm) + (pool is None))
    x = rng.randn(2, 8, 12, 16).astype(np.float32)
    jm = JA.ASPP(32, dilations=(1, 2, 3), norm=norm, pool_kernel_size=pool)
    v = random_variables(jm, 4, jnp.asarray(x))
    tm = port(PA.ASPP(16, 32, dilations=(1, 2, 3), norm=norm, pool_kernel_size=pool), v)
    close(nhwc(tm(nchw(x))), jm.apply(jnp_tree(v), jnp.asarray(x)), name="eval")
    ref, stats = apply_train(jm, v, jnp.asarray(x))
    close(nhwc(tm.train()(nchw(x))), ref, name="train")
    if norm == "BN":
        close(tm.norms[4].running_mean, stats["BatchNorm_4"]["mean"], name="mean")


def test_resize_bilinear_is_jax_image_resize():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 7, 9, 3).astype(np.float32)
    for size in ((14, 18), (28, 36), (3, 4), (7, 20), (1, 1)):
        ref = jax.image.resize(jnp.asarray(x), (2,) + size + (3,), "bilinear")
        close(nhwc(PA.resize_bilinear(nchw(x), size)), ref, name=str(size))
    one = rng.randn(2, 1, 1, 3).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(one), (2, 5, 6, 3), "bilinear")
    np.testing.assert_array_equal(nhwc(PA.resize_bilinear(nchw(one), (5, 6))), np.asarray(ref))


def _targets(rng, b, h, w, classes):
    t = rng.randint(0, classes, (b, h, w)).astype(np.int32)
    t[:, :3] = 255
    return t


@pytest.mark.parametrize("head,norm", [("v3", "GN"), ("v3plus", "GN"), ("v3plus", "BN")])
def test_deeplab_heads_and_loss_match_jax(head, norm):
    rng = np.random.RandomState(len(head) + len(norm))
    res2 = rng.randn(2, 16, 24, 8).astype(np.float32)
    res5 = rng.randn(2, 2, 3, 16).astype(np.float32)
    feats = {"res2": jnp.asarray(res2), "res5": jnp.asarray(res5)}
    tfeats = {"res2": nchw(res2), "res5": nchw(res5)}
    if head == "v3":
        jm = JDL.DeepLabV3Head(5, aspp_dim=16, norm=norm)
        tm = PDL.DeepLabV3Head(16, 5, aspp_dim=16, norm=norm)
        targets = _targets(rng, 2, 64, 96, 5)
    else:
        jm = JDL.DeepLabV3PlusHead(5, aspp_dim=16, low_dim=8, decoder_dim=16, norm=norm)
        tm = PDL.DeepLabV3PlusHead(16, 8, 5, aspp_dim=16, low_dim=8, decoder_dim=16, norm=norm)
        targets = _targets(rng, 2, 64, 96, 5)
    v = random_variables(jm, 6, feats)
    tm = port(tm, v)
    full, _ = jm.apply(jnp_tree(v), feats)
    got, losses = tm(tfeats)
    assert losses == {}
    close(nhwc(got), full, name="inference")
    (ref, ref_losses), stats = apply_train(jm, v, feats, targets=jnp.asarray(targets))
    got, losses = tm.train()(tfeats, torch.from_numpy(targets))
    close(nhwc(got), ref, name="train")
    np.testing.assert_allclose(float(losses["loss_sem_seg"]), float(ref_losses["loss_sem_seg"]),
                               rtol=1e-4)
    losses["loss_sem_seg"].backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in tm.parameters())


def test_hard_pixel_mining_loss_matches_jax():
    rng = np.random.RandomState(8)
    logits = rng.randn(2, 12, 10, 7).astype(np.float32) * 3
    targets = _targets(rng, 2, 12, 10, 7)
    for frac in (0.2, 0.05, 1.0):
        ref = JDL.hard_pixel_mining_loss(jnp.asarray(logits), jnp.asarray(targets), frac)
        got = PDL.hard_pixel_mining_loss(nchw(logits), torch.from_numpy(targets), frac)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


# ---------------------------------------------------------------------------
# Panoptic-DeepLab
# ---------------------------------------------------------------------------

def test_panoptic_deeplab_head_matches_jax():
    rng = np.random.RandomState(12)
    feats = {"res2": rng.randn(2, 16, 20, 8).astype(np.float32),
             "res5": rng.randn(2, 2, 3, 16).astype(np.float32)}
    jm = JPD.PanopticDeepLabHead(6, decoder_dim=16, head_dim=8)
    v = random_variables(jm, 7, {k: jnp.asarray(x) for k, x in feats.items()})
    tm = port(PPD.PanopticDeepLabHead(16, 8, 6, decoder_dim=16, head_dim=8), v)
    sem, center, offset = jm.apply(jnp_tree(v), {k: jnp.asarray(x) for k, x in feats.items()})
    tsem, tcenter, toffset = tm({k: nchw(x) for k, x in feats.items()})
    close(nhwc(tsem), sem, name="sem")
    close(tcenter.detach().numpy(), center, name="center")
    close(nhwc(toffset), offset, name="offset")


def _grouping_inputs(seed, h=24, w=30):
    rng = np.random.RandomState(seed)
    heat = rng.rand(h, w).astype(np.float32) * 0.6
    heat[5, 7] = heat[5, 8] = 0.9                              # a tie inside one window
    heat[17, 20] = 0.95
    offsets = (rng.randn(h, w, 2) * 4).astype(np.float32)
    thing = rng.rand(h, w) > 0.3
    return heat, offsets, thing


@pytest.mark.parametrize("seed,max_centers,kernel", [(0, 16, 7), (1, 4, 3), (2, 64, 5)])
def test_grouping_and_fusion_are_exact(seed, max_centers, kernel):
    heat, offsets, thing = _grouping_inputs(seed)
    ref_ids, ref_scores = JPD.group_pixels_to_instances(
        jnp.asarray(heat), jnp.asarray(offsets), jnp.asarray(thing), max_centers=max_centers,
        nms_kernel=kernel)
    ids, scores = PPD.group_pixels_to_instances(
        torch.from_numpy(heat), torch.from_numpy(offsets.transpose(2, 0, 1).copy()),
        torch.from_numpy(thing), max_centers=max_centers, nms_kernel=kernel)
    assert ids.dtype == torch.int32 and int(ids.max()) > 0
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(ref_scores))
    rng = np.random.RandomState(seed + 50)
    logits = rng.randn(24, 30, 6).astype(np.float32)
    thing_classes = np.array([True, False, True, True, False, False])
    ref = JPD.panoptic_deeplab_fusion(jnp.asarray(logits), ref_ids, jnp.asarray(thing_classes))
    got = PPD.panoptic_deeplab_fusion(torch.from_numpy(logits.transpose(2, 0, 1).copy()), ids,
                                      torch.from_numpy(thing_classes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# Rethinking BN
# ---------------------------------------------------------------------------

class _JNorm(fnn.Module):
    norm: str

    @fnn.compact
    def __call__(self, x, train: bool = False):
        mod = jget_norm(self.norm, x.shape[-1])
        return mod(x)


def test_get_norm_builds_the_batch_stats_norms():
    for name, sync in (("BNBatchStats", False), ("SyncBNBatchStats", True)):
        n = get_norm(name, 8)
        assert isinstance(n, PR.BatchNormBatchStats) and n.sync == sync
        assert isinstance(n, BatchNorm2d)                       # a BN checkpoint loads
        n.load_state_dict(BatchNorm2d(8).state_dict(), strict=True)


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_batch_stats_matches_jax(train):
    rng = np.random.RandomState(int(train))
    x = (rng.randn(4, 5, 6, 8) * 2 + 1).astype(np.float32)
    jm = _JNorm("BNBatchStats")
    v = random_variables(jm, 2, jnp.asarray(x))
    if train:
        ref, new = jm.apply(jnp_tree(v), jnp.asarray(x), mutable=["batch_stats"])
    else:
        ref, new = jm.apply(jnp_tree(v), jnp.asarray(x)), v
    n = port(get_norm("BNBatchStats", 8), {"params": v["params"]["BatchNormBatchStats_0"],
                                           "batch_stats": v["batch_stats"]["BatchNormBatchStats_0"]})
    n.train(train)
    got = n(nchw(x))
    assert got.dtype == torch.float32
    close(nhwc(got), ref)
    stats = new["batch_stats"]["BatchNormBatchStats_0"]
    close(n.running_mean, stats["mean"], name="mean")
    close(n.running_var, stats["var"], name="var")


class _JShared(fnn.Module):
    @fnn.compact
    def __call__(self, feats, train: bool = True):
        return JR.shared_levels_norm(jget_norm("BN", feats[0].shape[-1]), feats, train)


@pytest.mark.parametrize("train", [True, False])
def test_shared_levels_norm_matches_jax(train):
    rng = np.random.RandomState(3)
    feats = [rng.randn(2, s, s + 1, 8).astype(np.float32) for s in (8, 4, 2)]
    jm = _JShared()
    v = random_variables(jm, 5, [jnp.asarray(f) for f in feats])
    ref, new = jm.apply(jnp_tree(v), [jnp.asarray(f) for f in feats], train=train,
                        mutable=["batch_stats"])
    n = port(get_norm("BN", 8), {"params": v["params"]["BatchNorm_0"],
                                 "batch_stats": v["batch_stats"]["BatchNorm_0"]}).train(train)
    got = PR.shared_levels_norm(n, [nchw(f) for f in feats])
    for g, r in zip(got, ref):
        close(nhwc(g), r)
    close(n.running_mean, new["batch_stats"]["BatchNorm_0"]["mean"])


@functools.lru_cache(maxsize=None)
def _shared_bn_retinanet():
    over = {"resnet.norm": "FrozenBN", "fpn.norm": "", "retinanet.head_norm": "BN",
            "retinanet.head_shared_bn": True}
    cfg_j = tiny(jconfig.Config(), "RetinaNet", **over)
    cfg_t = tiny(tconfig.Config(), "RetinaNet", **over)
    rng = np.random.RandomState(3)
    images = (rng.rand(2, 128, 128, 3) * 255).astype(np.float32)
    sizes = np.array([[128, 128]] * 2, np.int32)
    boxes = np.array([[[10, 12, 60, 70], [30, 40, 120, 110]]] * 2, np.float32)
    classes, valid = np.array([[1, 3]] * 2, np.int32), np.ones((2, 2), bool)
    feats = {f"p{l}": rng.randn(2, 128 >> l, 128 >> l, 32).astype(np.float32)
             for l in range(3, 8)}
    jm = jbuild(cfg_j)
    v = random_variables(jm, 8, jnp.asarray(images), jnp.asarray(sizes), train=False)
    jgt = JGt(jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid))
    losses, new = jm.apply(jnp_tree(v), {k: jnp.asarray(f) for k, f in feats.items()},
                           method=lambda m, f: m.head(f, jnp.asarray(sizes), gt=jgt, train=True),
                           mutable=["batch_stats"])
    model = port_from(v, build_model(cfg_t, device="cpu")).train()
    gt = GtInstances(torch.from_numpy(boxes), torch.from_numpy(classes), torch.from_numpy(valid))
    got = model._detector[0]({k: nchw(f) for k, f in feats.items()}, torch.from_numpy(sizes),
                             gt=gt, train=True)
    stats = {**v["batch_stats"], **new["batch_stats"]}
    return got, losses, model, from_jax(v["params"], stats)


def test_head_shared_bn_retinanet_losses_match_jax():
    got, ref, _, _ = _shared_bn_retinanet()
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4, err_msg=k)


def test_head_shared_bn_retinanet_statistics_match_jax():
    _, _, model, ref_state = _shared_bn_retinanet()
    state = model.state_dict()
    keys = [k for k in ref_state if k.startswith("head.") and k.endswith("running_mean")]
    assert len(keys) == 8                                     # one norm per tower layer
    for k in keys:
        for name in (k, k.replace("running_mean", "running_var")):
            np.testing.assert_allclose(state[name].numpy(), ref_state[name].numpy(),
                                       rtol=1e-3, atol=1e-3 * float(ref_state[name].abs().max()),
                                       err_msg=name)


def test_recipes_set_the_jax_package_fields():
    from u2seg_tpu.projects import rethinking_bn as jr

    for fn in ("mask_rcnn_bn_head", "mask_rcnn_syncbn_head", "mask_rcnn_bn_head_batch_stats"):
        c, jc = getattr(PR, fn)(), getattr(jr, fn)()
        for head in ("box_head", "mask_head"):
            a, b = getattr(c.model.roi_heads, head), getattr(jc.model.roi_heads, head)
            assert (a.norm, a.num_conv) == (b.norm, b.num_conv)
        assert c.model.roi_heads.box_head.num_fc == jc.model.roi_heads.box_head.num_fc
    for shared in (False, True):
        c, jc = PR.retinanet_syncbn_head(shared_training=shared), jr.retinanet_syncbn_head(
            shared_training=shared)
        assert (c.head_norm, c.head_shared_bn) == (jc.head_norm, jc.head_shared_bn)


def test_recompute_domain_stats_averages_the_batches():
    torch.manual_seed(0)
    bn = BatchNorm2d(3)
    model = torch.nn.Sequential(bn)
    batches = [torch.randn(4, 3, 5, 5) * (i + 1) + i for i in range(3)]
    n = PR.recompute_domain_stats(model, lambda x: model.train()(x), batches, num_iters=3)
    assert n == 3
    means = torch.stack([b.mean(dim=(0, 2, 3)) for b in batches]).mean(0)
    close(bn.running_mean, means.numpy())


def test_shufflebn_round_trip_over_two_gloo_ranks(tmp_path):
    from torch_shufflebn_worker import CHANNELS, ROWS, SEED, inputs

    world = 2
    init = "file://" + str(tmp_path / "rendezvous")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), init, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    xs = [inputs(r)[0] for r in range(world)]
    perm = torch.randperm(world * ROWS, generator=torch.Generator().manual_seed(SEED))
    for r in range(world):
        assert torch.equal(res[r]["back"], xs[r])               # each rank's own rows back
        assert torch.equal(res[r]["perm"], perm)                # one permutation everywhere
    # the same arithmetic in one process: permute, a BN per rank's chunk, restore
    all_x = torch.cat(xs)[perm]
    ys = []
    for r in range(world):
        bn = BatchNorm2d(CHANNELS).train()
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, CHANNELS))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, CHANNELS))
        ys.append(bn(all_x[r * ROWS:(r + 1) * ROWS]))
        np.testing.assert_allclose(res[r]["running_mean"].numpy(), bn.running_mean.numpy(),
                                   atol=1e-6)
    all_y = torch.cat(ys)[torch.argsort(perm)]
    for r in range(world):
        np.testing.assert_allclose(res[r]["y"].numpy(), all_y[r * ROWS:(r + 1) * ROWS].detach().numpy(),
                                   atol=1e-6)
        assert torch.isfinite(res[r]["grad"]).all() and float(res[r]["grad"].abs().max()) > 0
