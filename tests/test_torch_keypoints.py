"""The keypoint pieces of u2seg_torch vs the JAX package on the CPU: heatmap
targets (points on the box's right and bottom edges, just outside, on the
left and top edges, far away, invisible), the argmax decoding, the 2x
bilinear upsample against ``jax.image.resize``, the loss, and the head
(``score_lowres``: flax's unflipped 4x4 stride-2 transposed conv with SAME
padding against torch's flipped one with padding 1).

Tolerances: bin indices, validity and argmax positions exact; decoded
coordinates, logits, probabilities and the upsample rtol 1e-6 (f32; bf16 at
the AMP tolerance rtol 0.05, atol 0.03 * max|ref|); the loss rtol 1e-5 and
its gradient w.r.t. the logits 1e-5 * max|grad|; the head rtol 1e-4 with
atol 1e-4 * max|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2seg_tpu.models import keypoint_head as jkh
from u2seg_tpu.structures import keypoints as jkp
from u2seg_torch.models import keypoint_head as tkh
from u2seg_torch.models.sem_seg import upsample_bilinear
from u2seg_torch.structures import keypoints as tkp

torch.set_num_threads(1)
S = 56


def edge_cases():
    """rois (N, 4) and keypoints (N, 17, 3) with the awkward points first."""
    rng = np.random.RandomState(0)
    n = 8
    xy = rng.rand(n, 2) * 200
    wh = rng.rand(n, 2) * 150 + 1
    rois = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    rois[0] = [10.0, 20.0, 10.0, 40.0]                   # zero width
    u = rng.uniform(-0.2, 1.2, (n, 17, 2))
    kp = rois[:, None, :2] + u * (rois[:, None, 2:] - rois[:, None, :2])
    x0, y0, x1, y1 = (rois[:, i:i + 1] for i in range(4))
    kp[:, 0] = np.concatenate([x1, y0 + 1], 1)           # right edge
    kp[:, 1] = np.concatenate([x0 + 1, y1], 1)           # bottom edge
    kp[:, 2] = np.concatenate([x1, y1], 1)               # bottom-right corner
    kp[:, 3] = np.concatenate([x1 + 1e-3, y0 + 1], 1)    # just outside right
    kp[:, 4] = np.concatenate([x0 + 1, y1 + 1e-3], 1)    # just outside bottom
    kp[:, 5] = np.concatenate([x0, y0], 1)               # top-left corner
    kp[:, 6] = np.concatenate([x0 - 1e-3, y0 + 1], 1)    # just outside left
    kp[:, 7] = np.concatenate([x0 + 1e5, y0 - 1e5], 1)   # far away
    kp[:, 8] = np.concatenate([x1 - 5e-5, y1 - 5e-5], 1)  # within 1e-4 of the edge
    vis = rng.randint(1, 3, (n, 17, 1)).astype(np.float32)
    vis[:, 9:11] = 0                                     # not visible
    return rois, np.concatenate([kp, vis], -1).astype(np.float32)


def test_heatmap_targets_match_jax():
    rois, kp = edge_cases()
    ref_lin, ref_valid = jax.jit(jkp.keypoints_to_heatmap, static_argnums=2)(
        jnp.asarray(kp), jnp.asarray(rois), S)
    lin, valid = tkp.keypoints_to_heatmap(torch.from_numpy(kp), torch.from_numpy(rois), S)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(lin.numpy()[valid.numpy()],
                                  np.asarray(ref_lin)[np.asarray(ref_valid)])
    v = valid.numpy()
    assert v[1:, 0].all() and v[1:, 1].all() and v[1:, 2].all()   # the edges count
    assert not v[:, 3].any() and not v[:, 4].any() and not v[:, 6].any()
    assert not v[:, 7].any() and not v[:, 9:11].any()
    assert (lin.numpy()[1:, 2] == S * S - 1).all()                 # the last bin


def test_decoding_matches_jax():
    rng = np.random.RandomState(1)
    rois, _ = edge_cases()
    maps = rng.randn(len(rois), S, S, 17).astype(np.float32)
    maps[2, 5, 7, 3] = maps[2, 30, 1, 3] = maps[2].max() + 1.0     # a tie: the first wins
    ref = np.asarray(jax.jit(jkp.heatmaps_to_keypoints)(jnp.asarray(maps), jnp.asarray(rois)))
    got = tkp.heatmaps_to_keypoints(torch.from_numpy(maps), torch.from_numpy(rois)).numpy()
    assert got.shape == (8, 17, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    w = max(rois[2, 2] - rois[2, 0], 1e-6) / S
    assert np.isclose(got[2, 3, 0], (7 + 0.5) * w + rois[2, 0])


@pytest.mark.parametrize("shape", [(3, 7, 5, 4), (2, 1, 1, 3), (1, 14, 14, 17)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_2x_upsample_matches_jax_image_resize(shape, dtype):
    """Half-pixel bilinear 2x: jax.image.resize renormalizes the weights of
    the samples inside the image at the border, the port clamps the edge
    sample; both give the edge sample weight 1."""
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    b, h, w, c = shape
    ref = jax.image.resize(jnp.asarray(x, dtype), (b, 2 * h, 2 * w, c), "bilinear")
    got = upsample_bilinear(torch.from_numpy(x).to(getattr(torch, dtype))
                            .permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.03 * np.abs(ref).max())
    np.testing.assert_allclose(got[:, 0, 0], x[:, 0, 0], rtol=0.01 if dtype != "float32" else 1e-6)


@pytest.mark.parametrize("normalizer", [None, 4.0])
def test_keypoint_loss_matches_jax(normalizer):
    rois, kp = edge_cases()
    rng = np.random.RandomState(3)
    logits = rng.randn(len(rois), S, S, 17).astype(np.float32)
    live = np.array([1, 1, 1, 0, 1, 1, 1, 1], bool)

    def jloss(lg):
        return jkh.keypoint_rcnn_loss(lg, jnp.asarray(kp), jnp.asarray(rois),
                                      jnp.asarray(live), normalizer=normalizer)

    ref, ref_g = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = tkh.keypoint_rcnn_loss(lt, torch.from_numpy(kp), torch.from_numpy(rois),
                                 torch.from_numpy(live), normalizer=normalizer)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    ref_g = np.asarray(ref_g)
    np.testing.assert_allclose(lt.grad.numpy(), ref_g, rtol=0,
                               atol=1e-5 * np.abs(ref_g).max())
    assert float(got.detach()) > 0


def test_keypoint_head_matches_jax():
    jm = jkh.KRCNNConvDeconvUpsampleHead(num_keypoints=5, conv_dims=(8, 8))
    x = np.random.RandomState(4).randn(3, 14, 14, 6).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.RandomState(5)
    v = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32) * 0.3, v)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    head = tkh.KRCNNConvDeconvUpsampleHead(6, 5, (8, 8))
    p = v["params"]
    sd = {}
    for i in (1, 2):
        sd[f"conv_fcn{i}.weight"] = np.asarray(p[f"conv_fcn{i}"]["kernel"]).transpose(3, 2, 0, 1)
        sd[f"conv_fcn{i}.bias"] = np.asarray(p[f"conv_fcn{i}"]["bias"])
    # flax applies the transposed kernel unflipped; torch flips it
    sd["score_lowres.weight"] = np.asarray(p["score_lowres"]["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
    sd["score_lowres.bias"] = np.asarray(p["score_lowres"]["bias"])
    head.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in sd.items()})
    with torch.no_grad():
        got = head(torch.from_numpy(x))
    assert got.shape == ref.shape == (3, 56, 56, 5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
