"""u2seg_torch heads vs the JAX package, module by module.

One seeded port model at a tiny config (R50 depth, narrow widths, 7
classes) is converted with the JAX package's own
``convert_d2_panoptic_fpn``; each JAX head then runs on its subtree, and the
port's head on the same numpy inputs. Biases, norm affines and BN statistics
are randomized so every term of the folded affines is exercised.

Tolerances: f32 rtol 1e-4 with atol 1e-4 * max|ref|; discrete outputs
(classes, validity) exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2seg_tpu.config.config import Config as JConfig
from u2seg_tpu.engine.checkpoint import convert_d2_panoptic_fpn
from u2seg_torch.config import Config as TConfig
from u2seg_torch.models.build import build_model

torch.set_num_threads(1)


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
    m.roi_heads.num_classes = 7
    m.roi_heads.box_head.fc_dim = 64
    m.roi_heads.mask_head.conv_dim = 32
    m.roi_heads.detections_per_image = 20
    m.roi_heads.pooler_impl = "gather"
    m.sem_seg_head.conv_dim = 32
    m.sem_seg_head.num_classes = 5
    return cfg


def randomize(model, rng):
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith(("running_mean", ".bias")):
                v.copy_(torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.1))
            elif k.endswith(("running_var", "norm.weight")):
                v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
    return model


@pytest.fixture(scope="module")
def pair():
    cfg_t, cfg_j = tiny(TConfig()), tiny(JConfig())
    model = randomize(build_model(cfg_t, device="cpu"), np.random.RandomState(0))
    params, _ = convert_d2_panoptic_fpn(
        {k: v.numpy() for k, v in model.state_dict().items()})
    return model, params, cfg_j


def nhwc_features(rng, b=2, c=32, h=32, w=40):
    return {f"p{i + 2}": rng.randn(b, h >> i, w >> i, c).astype(np.float32)
            for i in range(5)}


def to_port(feats):
    return {k: torch.from_numpy(v).permute(0, 3, 1, 2)
            .contiguous(memory_format=torch.channels_last) for k, v in feats.items()}


def test_box_head_nchw_flatten(pair):
    from u2seg_tpu.models.roi_heads import FastRCNNConvFCHead, FastRCNNOutputLayers

    model, params, _ = pair
    x = np.random.RandomState(1).randn(9, 7, 7, 32).astype(np.float32)
    ref = FastRCNNConvFCHead(fc_dim=64).apply(
        {"params": params["roi_heads"]["box_head1"]}, jnp.asarray(x))
    got = model.roi_heads.box_head[1](torch.from_numpy(x))
    close(got, ref)
    rs, rd = FastRCNNOutputLayers(7).apply(
        {"params": params["roi_heads"]["box_predictor1"]}, ref)
    gs, gd = model.roi_heads.box_predictor[1](got)
    close(gs, rs)
    close(gd, rd)


@pytest.mark.parametrize("select", [True, False])
def test_mask_head_class_select(pair, select):
    from u2seg_tpu.models.roi_heads import MaskRCNNConvUpsampleHead

    model, params, _ = pair
    rng = np.random.RandomState(2)
    x = rng.randn(6, 14, 14, 32).astype(np.float32)
    cls = np.array([0, 3, 6, 2, 1, 6], np.int32) if select else None
    ref = MaskRCNNConvUpsampleHead(num_classes=7, conv_dim=32).apply(
        {"params": params["roi_heads"]["mask_head"]}, jnp.asarray(x),
        class_idx=None if cls is None else jnp.asarray(cls))
    got = model.roi_heads.mask_head(
        torch.from_numpy(x), None if cls is None else torch.from_numpy(cls))
    assert got.shape == ref.shape
    close(got, ref)


@pytest.mark.parametrize("per_class", [False, True])
def test_fast_rcnn_inference_7_classes(per_class):
    from u2seg_tpu.models.roi_heads import fast_rcnn_inference as jfri
    from u2seg_torch.models.roi_heads import fast_rcnn_inference as tfri

    rng = np.random.RandomState(3)
    b, k, c = 2, 150, 7
    logits = rng.randn(b, k, c + 1).astype(np.float32) * 2
    logits[0, :10] = logits[0, 10:20]            # exact score ties
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    xy = rng.rand(b, k, 1, 2) * 100
    wh = rng.rand(b, k, c if per_class else 1, 2) * 40 + 4
    boxes = np.concatenate([xy + 0 * wh, xy + wh], -1).reshape(b, k, -1)
    boxes = boxes.astype(np.float32)
    valid = rng.rand(b, k) > 0.1
    sizes = np.array([[120, 130], [90, 110]], np.int32)
    args = (boxes, probs.astype(np.float32), valid, sizes)
    ref = jfri(*[jnp.asarray(a) for a in args], 0.05, 0.5, 40)
    got = tfri(*[torch.from_numpy(a) for a in args], 0.05, 0.5, 40)
    exact(got.valid, ref.valid)
    assert int(np.asarray(ref.valid).sum()) > 20
    exact(got.classes, ref.classes)
    close(got.boxes, ref.boxes)
    close(got.scores, ref.scores)


def test_cascade_inference_stages_gather(pair):
    """Three cascade stages + fast_rcnn_inference + the mask branch on the
    same features and proposals (pooler_impl="gather" on both sides)."""
    from u2seg_tpu.models.roi_heads import CascadeROIHeads

    model, params, cfg_j = pair
    rng = np.random.RandomState(4)
    feats = nhwc_features(rng)
    b, k = 2, 60
    xy = rng.rand(b, k, 2) * 110
    wh = rng.rand(b, k, 2) * 60 + 4
    boxes = np.concatenate([xy, np.minimum(xy + wh, [160, 128])], -1).astype(np.float32)
    scores = rng.randn(b, k).astype(np.float32)
    valid = np.ones((b, k), bool)
    valid[1, -5:] = False
    sizes = np.array([[128, 160], [120, 150]], np.int32)
    heads = CascadeROIHeads(cfg_j.model.roi_heads, dtype=jnp.float32)
    ref = jax.jit(lambda p, *a: heads.apply({"params": p}, *a, train=False))(
        params["roi_heads"], {n: jnp.asarray(v) for n, v in feats.items()},
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
        jnp.asarray(sizes))
    with torch.no_grad():
        got = model.roi_heads(to_port(feats), torch.from_numpy(boxes),
                              torch.from_numpy(scores), torch.from_numpy(valid),
                              torch.from_numpy(sizes))
    exact(got.valid, ref.valid)
    assert int(np.asarray(ref.valid).sum()) > 0
    exact(got.classes, ref.classes)
    close(got.boxes, ref.boxes)
    close(got.scores, ref.scores)
    close(got.mask_logits, ref.mask_logits)


def test_sem_seg_head(pair):
    from u2seg_tpu.models.sem_seg import SemSegFPNHead

    model, params, cfg_j = pair
    feats = nhwc_features(np.random.RandomState(5))
    ref, _ = SemSegFPNHead(cfg_j.model.sem_seg_head).apply(
        {"params": params["sem_seg_head"]},
        {n: jnp.asarray(v) for n, v in feats.items()})
    with torch.no_grad():
        got = model.sem_seg_head(to_port(feats))
    close(got, ref)


@pytest.mark.parametrize("s", [2, 4])
def test_upnx_axis(s):
    from u2seg_tpu.models.sem_seg import upsample_bilinear as jup
    from u2seg_torch.models.sem_seg import upsample_bilinear as tup

    x = np.random.RandomState(s).randn(2, 5, 7, 3).astype(np.float32)
    ref = jup(jnp.asarray(x), s)                                  # NHWC
    got = tup(torch.from_numpy(x).permute(0, 3, 1, 2), s).permute(0, 2, 3, 1)
    close(got, ref)


def test_sem_seg_group_norm_eps():
    """Low-variance input where the epsilon dominates: the port's sem-seg
    GroupNorm equals flax's GroupNorm with its default epsilon (1e-6)."""
    import flax.linen as fnn

    from u2seg_torch.models.sem_seg import SEM_SEG_GN_EPS
    from u2seg_torch.ops.norms import GroupNorm

    x = (np.random.RandomState(6).randn(2, 4, 4, 64) * 1e-3).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=32)
    ref = gn.apply(gn.init(jax.random.PRNGKey(0), jnp.asarray(x)), jnp.asarray(x))
    assert SEM_SEG_GN_EPS == 1e-6
    got = GroupNorm(32, 64, eps=SEM_SEG_GN_EPS)(
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got, ref)
    off = GroupNorm(32, 64, eps=1e-5)(
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert np.abs(off.detach().numpy() - np.asarray(ref)).max() > 0.1


@pytest.mark.parametrize("norm", ["SyncBN", "FrozenBN", "GN"])
def test_norms_match_jax(norm):
    """Inference-mode norms: folded BN (running statistics) and GroupNorm,
    each with random affine and statistics, vs the JAX package's get_norm."""
    from u2seg_tpu.ops.norms import get_norm as jget
    from u2seg_torch.ops.norms import get_norm as tget

    rng = np.random.RandomState(7)
    c = 64
    x = (rng.randn(2, 5, 6, c) * 3 + 1).astype(np.float32)
    mod = tget(norm, c)
    with torch.no_grad():
        for _, p in mod.named_parameters():
            p.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, p.shape).astype(np.float32)))
        for _, b in mod.named_buffers():
            b.copy_(torch.from_numpy(rng.uniform(0.2, 2.0, b.shape).astype(np.float32)))
    jmod = jget(norm, c)
    if norm == "GN":
        variables = {"params": {"scale": jnp.asarray(mod.weight.detach().numpy()),
                                "bias": jnp.asarray(mod.bias.detach().numpy())}}
        ref = jmod.apply(variables, jnp.asarray(x))
    else:
        params = {"scale": mod.weight.detach().numpy(), "bias": mod.bias.detach().numpy()}
        stats = {"mean": mod.running_mean.numpy(), "var": mod.running_var.numpy()}
        variables = {"params": params, "batch_stats": stats}
        ref = (jmod.apply(variables, jnp.asarray(x)) if norm == "FrozenBN" else
               jmod.apply(variables, jnp.asarray(x), use_running_average=True))
    got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got, ref)
