"""Train-path ops of u2seg_torch vs the JAX package: losses, matcher,
fg/bg sampling, box deltas, train-mode BatchNorm, mask targets.

The same numpy-seeded inputs go through the JAX function and its counterpart
in the port. Tolerances: f32 rtol 1e-5 with atol 1e-5 * max|ref| (1e-6 *
max|ref| where only elementwise f32 ops are involved); discrete outputs
(matched indices, labels, sampled indices, masks) exact.
"""
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2seg_tpu.models import matcher as jmatcher
from u2seg_tpu.models import roi_heads as jroi
from u2seg_tpu.models import sampling as jsampling
from u2seg_tpu.ops import losses as jlosses
from u2seg_tpu.ops import norms as jnorms
from u2seg_tpu.structures import boxes as jboxes
from u2seg_torch.models import matcher as tmatcher
from u2seg_torch.models import roi_heads as troi
from u2seg_torch.models import sampling as tsampling
from u2seg_torch.ops import losses as tlosses
from u2seg_torch.ops import norms as tnorms
from u2seg_torch.structures import boxes as tboxes

torch.set_num_threads(1)
FIXTURES = os.path.join(os.path.dirname(__file__), "golden", "fixtures")


def close(got, ref, tol=1e-5):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    atol = tol * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=atol)


def exact(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got.astype(np.int64), np.asarray(ref).astype(np.int64))


def load_cases(name):
    data = np.load(os.path.join(FIXTURES, name))
    n = int(data["n_cases"])
    keys = {k.split("_", 1)[1] for k in data.files if k != "n_cases"}
    return [{k: data[f"c{i}_{k}"] for k in keys if f"c{i}_{k}" in data.files}
            for i in range(n)]


def _boxes(rng, n, scale=100.0):
    xy = rng.rand(n, 2) * scale
    wh = rng.rand(n, 2) * scale * 0.5 + 1
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta", [0.0, 0.5, 1.0 / 9])
def test_smooth_l1(beta):
    rng = np.random.RandomState(0)
    a, b = rng.randn(50, 4).astype(np.float32), rng.randn(50, 4).astype(np.float32)
    close(tlosses.smooth_l1(torch.from_numpy(a), torch.from_numpy(b), beta),
          jlosses.smooth_l1(jnp.asarray(a), jnp.asarray(b), beta), 1e-6)


@pytest.mark.parametrize("name", ["giou_loss", "diou_loss", "ciou_loss"])
def test_iou_losses(name):
    rng = np.random.RandomState(1)
    a, b = _boxes(rng, 64), _boxes(rng, 64)
    a[:4] = b[:4]                       # identical boxes
    b[4:8, 2:] = b[4:8, :2]             # empty boxes
    close(getattr(tlosses, name)(torch.from_numpy(a), torch.from_numpy(b)),
          getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b)))


def test_bce_and_focal():
    rng = np.random.RandomState(2)
    x = (rng.randn(40, 9) * 6).astype(np.float32)
    t = (rng.rand(40, 9) > 0.5).astype(np.float32)
    close(tlosses.bce_with_logits(torch.from_numpy(x), torch.from_numpy(t)),
          jlosses.bce_with_logits(jnp.asarray(x), jnp.asarray(t)))
    close(tlosses.sigmoid_focal_loss(torch.from_numpy(x), torch.from_numpy(t)),
          jlosses.sigmoid_focal_loss(jnp.asarray(x), jnp.asarray(t)))
    # bf16 logits are computed in f32 on both sides
    got = tlosses.bce_with_logits(torch.from_numpy(x).bfloat16(), torch.from_numpy(t))
    ref = jlosses.bce_with_logits(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(t))
    assert got.dtype == torch.float32
    close(got, ref)


def test_softmax_ce_and_ignore():
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 6, 5, 8) * 3).astype(np.float32)
    lab = rng.randint(0, 8, (2, 6, 5)).astype(np.int32)
    lab[0, 0, 0], lab[1, 2, 3] = 8, -1           # out of range: clamped
    close(tlosses.softmax_ce(torch.from_numpy(x), torch.from_numpy(lab)),
          jlosses.softmax_ce(jnp.asarray(x), jnp.asarray(lab)))
    lab[0, 1:3] = 255
    close(tlosses.softmax_ce_ignore(torch.from_numpy(x), torch.from_numpy(lab)),
          jlosses.softmax_ce_ignore(jnp.asarray(x), jnp.asarray(lab)))
    allig = np.full_like(lab, 255)
    assert float(tlosses.softmax_ce_ignore(torch.from_numpy(x),
                                           torch.from_numpy(allig))) == 0.0


def test_softmax_ce_gradient():
    rng = np.random.RandomState(4)
    x = (rng.randn(7, 11) * 2).astype(np.float32)
    lab = rng.randint(0, 11, 7).astype(np.int32)
    ref = jax.grad(lambda v: jlosses.softmax_ce(v, jnp.asarray(lab)).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tlosses.softmax_ce(xt, torch.from_numpy(lab)).sum().backward()
    close(xt.grad, ref)


# ---------------------------------------------------------------------------
# matcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(18))
def test_matcher_golden(case):
    c = load_cases("matcher.npz")[case]
    q = torch.from_numpy(c["quality"])
    idx, lab = tmatcher.match(
        q, torch.ones(q.shape[0], dtype=torch.bool),
        tuple(float(t) for t in c["thresholds"]),
        tuple(int(v) for v in c["labels"]), bool(c["allow_lq"]))
    assert lab.dtype == torch.int8
    exact(lab, c["match_labels"])
    exact(idx, c["match_idx"])


@pytest.mark.parametrize("allow_lq", [False, True])
@pytest.mark.parametrize("valid_kind", ["all", "some", "none"])
def test_matcher_matches_jax(allow_lq, valid_kind):
    rng = np.random.RandomState(5)
    q = rng.rand(2, 6, 50).astype(np.float32)
    q[0, 1] = q[0, 3]                       # tied gt rows: first index wins
    q[1, 2] = 0.0                           # a gt overlapping nothing (the quirk)
    q[:, :, :5] = np.round(q[:, :, :5], 1)  # ties at a gt's maximum
    valid = {"all": np.ones((2, 6), bool), "none": np.zeros((2, 6), bool),
             "some": rng.rand(2, 6) > 0.4}[valid_kind]
    idx, lab = tmatcher.match(torch.from_numpy(q), torch.from_numpy(valid),
                              (0.3, 0.7), (0, -1, 1), allow_lq)
    for i in range(2):
        ridx, rlab = jmatcher.match(jnp.asarray(q[i]), jnp.asarray(valid[i]),
                                    (0.3, 0.7), (0, -1, 1), allow_lq)
        exact(idx[i], ridx)
        exact(lab[i], rlab)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _jax_keys(rng_key, n):
    """The two uniform key vectors ``subsample_labels`` of the JAX package
    draws from ``rng_key``."""
    kp, kn = jax.random.split(rng_key)
    return (np.array(jax.random.uniform(kp, (n,))),
            np.array(jax.random.uniform(kn, (n,))))


@pytest.mark.parametrize("n,num,frac,p_pos,p_neg", [
    (500, 64, 0.5, 0.1, 0.6),     # enough of both
    (500, 64, 0.25, 0.01, 0.9),   # few positives: negatives fill up
    (300, 128, 0.5, 0.6, 0.05),   # few negatives
    (40, 64, 0.5, 0.3, 0.3),      # fewer candidates than slots (kcap = n)
    (100, 32, 0.5, 0.0, 0.0),     # nothing to sample
])
def test_subsample_labels_with_jax_keys(n, num, frac, p_pos, p_neg):
    rng = np.random.RandomState(6)
    u = rng.rand(n)
    labels = np.where(u < p_pos, 1, np.where(u < p_pos + p_neg, 0, -1)).astype(np.int8)
    key = jax.random.PRNGKey(7)
    ridx, rvalid, rpos = jsampling.subsample_labels(key, jnp.asarray(labels), num, frac)
    pk, nk = _jax_keys(key, n)
    idx, valid, pos = tsampling.subsample_labels(
        torch.from_numpy(labels), num, frac,
        pos_keys=torch.from_numpy(pk), neg_keys=torch.from_numpy(nk))
    exact(valid, rvalid)
    exact(pos, rpos)
    exact(idx, ridx)                    # every slot, the unused ones too


@pytest.mark.parametrize("case", range(5))
def test_subsample_labels_golden_counts(case):
    c = load_cases("subsample_labels.npz")[case]
    labels = torch.from_numpy(c["labels"])
    g = torch.Generator().manual_seed(case)
    idx, valid, pos = tsampling.subsample_labels(
        labels, int(c["num_samples"]), float(c["pos_frac"]), generator=g)
    assert int((valid & pos).sum()) == int(c["num_pos"])
    assert int((valid & ~pos).sum()) == int(c["num_neg"])
    assert bool((labels[idx[valid & pos]] == 1).all())
    assert bool((labels[idx[valid & ~pos]] == 0).all())
    assert idx[valid].unique().numel() == int(valid.sum())      # no repeats
    # the generator decides the subset: same seed same draw, other seed another
    again = tsampling.subsample_labels(
        labels, int(c["num_samples"]), float(c["pos_frac"]),
        generator=torch.Generator().manual_seed(case))[0]
    exact(again, idx)


def test_subsample_labels_batched_rows_are_independent():
    rng = np.random.RandomState(8)
    labels = torch.from_numpy(rng.randint(-1, 2, (3, 200)).astype(np.int8))
    pk, nk = torch.from_numpy(rng.rand(3, 200)), torch.from_numpy(rng.rand(3, 200))
    idx, valid, pos = tsampling.subsample_labels(labels, 48, 0.5, pos_keys=pk, neg_keys=nk)
    for i in range(3):
        one = tsampling.subsample_labels(labels[i], 48, 0.5, pos_keys=pk[i], neg_keys=nk[i])
        exact(idx[i], one[0]); exact(valid[i], one[1]); exact(pos[i], one[2])


# ---------------------------------------------------------------------------
# box deltas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_get_deltas(weights):
    rng = np.random.RandomState(9)
    src, tgt = _boxes(rng, 80), _boxes(rng, 80)
    src[:3, 2:] = src[:3, :2]               # degenerate sources are floored
    got = tboxes.get_deltas(torch.from_numpy(src), torch.from_numpy(tgt), weights)
    ref = jboxes.get_deltas(jnp.asarray(src), jnp.asarray(tgt), weights)
    close(got, ref)
    back = tboxes.apply_deltas(got[3:], torch.from_numpy(src[3:]), weights)
    np.testing.assert_allclose(back.numpy(), tgt[3:], rtol=1e-4, atol=1e-3)


def test_get_deltas_golden():
    for c in load_cases("box_transform.npz"):
        weights = tuple(float(w) for w in c["weights"])
        got = tboxes.get_deltas(torch.from_numpy(c["src"]), torch.from_numpy(c["tgt"]),
                                weights)
        np.testing.assert_allclose(got.numpy(), c["deltas"], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# train-mode BatchNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["BN", "SyncBN"])
def test_batchnorm_train_matches_flax(norm):
    rng = np.random.RandomState(10)
    c = 6
    x = (rng.randn(3, 5, 7, c) * 2 + 1.5).astype(np.float32)      # NHWC
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    mean0 = rng.randn(c).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, c).astype(np.float32)
    # flax's SyncBN needs a bound axis; on one device it is BN, so the JAX
    # side is always "BN"
    jm = jnorms.get_norm("BN", c)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}

    tm = tnorms.get_norm(norm, c)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(scale)); tm.bias.copy_(torch.from_numpy(bias))
        tm.running_mean.copy_(torch.from_numpy(mean0))
        tm.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()

    tm.train()
    cot = rng.randn(*x.shape).astype(np.float32)
    for _ in range(2):                       # two steps: stats move twice
        ref, upd = jm.apply(variables, jnp.asarray(x), use_running_average=False,
                            mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        got = tm(xt)
    close(got.permute(0, 2, 3, 1), ref)
    close(tm.running_mean, variables["batch_stats"]["mean"])
    close(tm.running_var, variables["batch_stats"]["var"])
    # biased variance in the running stats (torch.nn.BatchNorm2d's is unbiased)
    v = x.reshape(-1, c).var(0)
    close(tm.running_var, 0.81 * var0 + 0.19 * v, 1e-4)

    # gradients flow through the batch moments
    def f(p, xx):
        y, _ = jm.apply({"params": p, "batch_stats": variables["batch_stats"]}, xx,
                        use_running_average=False, mutable=["batch_stats"])
        return (y * jnp.asarray(cot)).sum()
    gp, gx = jax.grad(f, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    (got * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    close(xt.grad.permute(0, 2, 3, 1), gx, 1e-4)
    close(tm.weight.grad, gp["scale"], 1e-4)
    close(tm.bias.grad, gp["bias"], 1e-4)

    # eval mode afterwards: the folded affine of the updated stats
    tm.eval()
    ref_eval = jm.apply(variables, jnp.asarray(x), use_running_average=True)
    close(tm(xt).permute(0, 2, 3, 1), ref_eval)


def test_frozen_batchnorm_never_trains():
    tm = tnorms.get_norm("FrozenBN", 4).train()
    x = torch.randn(2, 4, 3, 3, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    y = tm(x)
    y.sum().backward()
    assert tm.weight.grad is None and tm.bias.grad is None
    assert float(tm.running_mean.abs().max()) == 0.0
    close(y, x.detach() * float(1.0 / np.sqrt(1.0 + 1e-5)), 1e-6)


def test_batchnorm_train_bf16_output_dtype():
    tm = tnorms.get_norm("BN", 4).train()
    x = torch.randn(2, 4, 3, 3, generator=torch.Generator().manual_seed(0)).bfloat16()
    assert tm(x).dtype == torch.bfloat16 and tm.running_mean.dtype == torch.float32


# ---------------------------------------------------------------------------
# mask targets, gt append, gradient scaling
# ---------------------------------------------------------------------------

def test_mask_targets_from_patches():
    rng = np.random.RandomState(11)
    n, p = 12, 16
    patches = (rng.rand(n, p, p) > 0.5).astype(np.float32)
    gt = _boxes(rng, n)
    roi = gt + rng.randn(n, 4).astype(np.float32) * 6
    roi[:, 2:] = np.maximum(roi[:, 2:], roi[:, :2] + 1)
    gt[0, 2:] = gt[0, :2]                                # degenerate gt box
    for out in (14, 28):
        got = troi.mask_targets_from_patches(
            torch.from_numpy(patches), torch.from_numpy(gt), torch.from_numpy(roi), out)
        ref = jroi.mask_targets_from_patches(
            jnp.asarray(patches), jnp.asarray(gt), jnp.asarray(roi), out)
        assert got.shape == (n, out, out)
        close(got, ref)


def test_add_ground_truth_and_scale_gradient():
    from u2seg_torch.structures.instances import GtInstances

    rng = np.random.RandomState(12)
    gt = GtInstances(torch.from_numpy(_boxes(rng, 6).reshape(2, 3, 4)),
                     torch.zeros(2, 3, dtype=torch.int32),
                     torch.tensor([[True, True, False], [True, False, False]]))
    pb = torch.from_numpy(_boxes(rng, 10).reshape(2, 5, 4))
    boxes, scores, valid = troi.add_ground_truth_to_proposals(
        pb, torch.zeros(2, 5), torch.ones(2, 5, dtype=torch.bool), gt)
    assert boxes.shape == (2, 8, 4) and valid.sum() == 13
    assert scores[0, 5] == 10.0 and scores[0, 7] == -float("inf")

    x = torch.ones(3, requires_grad=True)
    y = troi.scale_gradient(x, 1.0 / 3)
    assert torch.equal(y, x)
    (y * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
    close(x.grad, np.array([1.0, 2.0, 3.0]) / 3, 1e-6)
