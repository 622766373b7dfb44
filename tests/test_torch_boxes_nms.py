"""u2seg_torch box utilities, NMS and inference glue vs the JAX package.

The same numpy inputs go through ``u2seg_tpu`` and ``u2seg_torch``.
Tolerances: f32 values rtol 1e-4 with atol 1e-4 * max|ref|; discrete
outputs (keep indices, validity, classes, panoptic ids) exact. The goldens
in ``tests/golden/fixtures`` (recorded from the reference's own code) are
read as ``tests/golden/test_glue_parity.py`` reads them, at that test's
tolerances.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2seg_tpu.ops import nms as jnms
from u2seg_tpu.structures import boxes as jbox
from u2seg_torch.ops import nms as tnms
from u2seg_torch.structures import boxes as tbox

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "golden", "fixtures")


def close(got, ref, rtol=1e-4):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    atol = 1e-4 * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def exact(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(ref))


def rand_boxes(rng, n, size=200.0, min_wh=1.0, max_wh=80.0):
    xy = rng.rand(n, 2).astype(np.float32) * size
    wh = (rng.rand(n, 2) * (max_wh - min_wh) + min_wh).astype(np.float32)
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_box_geometry_matches_jax():
    rng = np.random.RandomState(0)
    a = rand_boxes(rng, 37)
    b = rand_boxes(rng, 23)
    a[3] = [5.0, 5.0, 5.0, 9.0]          # zero width
    a[4] = [9.0, 9.0, 4.0, 3.0]          # negative extents
    close(tbox.area(torch.from_numpy(a)), jbox.area(jnp.asarray(a)))
    close(tbox.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)),
          jbox.pairwise_iou(jnp.asarray(a), jnp.asarray(b)))
    exact(tbox.nonempty(torch.from_numpy(a), 2.0),
          jbox.nonempty(jnp.asarray(a), 2.0))
    hw = np.array([120, 150], np.int32)
    close(tbox.clip(torch.from_numpy(a), (120, 150)),
          jbox.clip(jnp.asarray(a), jnp.asarray(hw)))
    close(tbox.clip(torch.from_numpy(a), torch.from_numpy(hw)),
          jbox.clip(jnp.asarray(a), jnp.asarray(hw)))


@pytest.mark.parametrize("k", [1, 3])
def test_apply_deltas_matches_jax(k):
    rng = np.random.RandomState(k)
    boxes = rand_boxes(rng, 50)
    deltas = (rng.randn(50, 4 * k) * 2).astype(np.float32)
    deltas[:5, 2::4] = 20.0              # past the scale clamp
    w = (10.0, 10.0, 5.0, 5.0)
    close(tbox.apply_deltas(torch.from_numpy(deltas), torch.from_numpy(boxes), w),
          jbox.apply_deltas(jnp.asarray(deltas), jnp.asarray(boxes), w))


def test_apply_deltas_matches_reference_golden():
    g = np.load(os.path.join(FIX, "box_transform.npz"))
    for i in range(int(g["n_cases"])):
        w = tuple(float(x) for x in g[f"c{i}_weights"])
        got = tbox.apply_deltas(torch.from_numpy(g[f"c{i}_big_deltas"]),
                                torch.from_numpy(g[f"c{i}_src"]), w)
        np.testing.assert_allclose(got.numpy(), g[f"c{i}_applied"],
                                   rtol=1e-4, atol=1e-3, err_msg=f"case {i}")


def _nms_cases():
    rng = np.random.RandomState(7)
    cases = {}
    # clustered boxes spanning three tiles, with exact score ties
    base = rand_boxes(rng, 40, size=300.0, min_wh=20.0, max_wh=90.0)
    boxes = np.repeat(base, 15, axis=0)[:600]
    boxes = boxes + rng.randn(*boxes.shape).astype(np.float32) * 4.0
    scores = np.round(rng.rand(600) * 20).astype(np.float32) / 20.0
    cases["tiles_ties"] = (boxes, scores)
    # all padding
    cases["all_padding"] = (rand_boxes(rng, 64),
                            np.full(64, -np.inf, np.float32))
    # a zero-area box and an all-zero box among valid ones
    b = rand_boxes(rng, 30)
    b[2] = [10.0, 10.0, 10.0, 30.0]
    b[5] = [0.0, 0.0, 0.0, 0.0]
    s = rng.rand(30).astype(np.float32)
    s[5] = 2.0
    s[7:10] = -np.inf
    cases["zero_box"] = (b, s)
    # suppression chains inside one tile: each box overlaps the next
    x = np.arange(20, dtype=np.float32) * 12.0
    chain = np.stack([x, np.zeros(20), x + 30.0, np.full(20, 30.0)], 1)
    cases["chain"] = (chain.astype(np.float32),
                      np.linspace(1.0, 0.1, 20).astype(np.float32))
    return cases


@pytest.mark.parametrize("name", ["tiles_ties", "all_padding", "zero_box", "chain"])
@pytest.mark.parametrize("thresh", [0.5, 0.65])
def test_nms_matches_jax(name, thresh):
    boxes, scores = _nms_cases()[name]
    max_out = min(100, len(boxes))
    ji, jv = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), thresh, max_out)
    ti, tv = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                      thresh, max_out)
    exact(tv, jv)
    exact(ti[tv], np.asarray(ji)[np.asarray(jv)])


def test_nms_batched_rows_match_jax_vmap():
    cases = _nms_cases()
    boxes = np.stack([cases["tiles_ties"][0][:300], cases["tiles_ties"][0][300:]])
    scores = np.stack([cases["tiles_ties"][1][:300], cases["tiles_ties"][1][300:]])
    ji, jv = jax.vmap(lambda b, s: jnms.nms(b, s, 0.6, 80))(
        jnp.asarray(boxes), jnp.asarray(scores))
    ti, tv = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.6, 80)
    exact(tv, jv)
    exact(torch.where(tv, ti, -1), np.where(np.asarray(jv), np.asarray(ji), -1))


def test_batched_nms_matches_jax():
    rng = np.random.RandomState(3)
    boxes = rand_boxes(rng, 300, size=150.0, min_wh=10.0, max_wh=60.0)
    scores = np.round(rng.rand(300) * 10).astype(np.float32) / 10.0
    idxs = rng.randint(0, 7, 300).astype(np.int32)
    ji, jv = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                              jnp.asarray(idxs), 0.5, 100)
    ti, tv = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                              torch.from_numpy(idxs), 0.5, 100)
    exact(tv, jv)
    exact(ti[tv], np.asarray(ji)[np.asarray(jv)])


# ---------------------------------------------------------------------------
# Inference-glue goldens (recorded from the reference's own code)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def glue():
    return dict(np.load(os.path.join(FIX, "glue_goldens.npz"), allow_pickle=False))


def test_rpn_proposal_selection_matches_golden(glue):
    g = glue
    nms_th, pre_nms, post_nms, min_sz, H, W = g["rpn.params"]
    pre_nms, post_nms = int(pre_nms), int(post_nms)
    nlvl = sum(1 for k in g if k.startswith("rpn.in.boxes."))
    bsz = g["rpn.in.boxes.0"].shape[0]
    kept = [[] for _ in range(bsz)]
    for li in range(nlvl):
        boxes = torch.from_numpy(g[f"rpn.in.boxes.{li}"])
        logits = torch.from_numpy(g[f"rpn.in.logits.{li}"])
        k = min(pre_nms, boxes.shape[1])
        score, idx = tnms.topk_stable(logits, k)
        box = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        box = tbox.clip(box, (H, W))
        ok = tbox.nonempty(box, threshold=float(min_sz))
        score = torch.where(ok, score, torch.full_like(score, -np.inf))
        kidx, kvalid = tnms.nms(box, score, float(nms_th), min(post_nms, k))
        for bi in range(bsz):
            sel = kidx[bi][kvalid[bi]].long()
            kept[bi].append((box[bi][sel].numpy(), score[bi][sel].numpy()))
    for bi in range(bsz):
        all_b = np.concatenate([b for b, _ in kept[bi]])
        all_s = np.concatenate([s for _, s in kept[bi]])
        order = np.argsort(-all_s, kind="stable")[:post_nms]
        ref_b, ref_s = g[f"rpn.out.boxes.{bi}"], g[f"rpn.out.logits.{bi}"]
        assert len(order) == len(ref_b)
        np.testing.assert_allclose(all_s[order], ref_s, rtol=1e-6)
        np.testing.assert_allclose(all_b[order], ref_b, rtol=1e-5, atol=1e-4)


def test_fast_rcnn_inference_matches_golden(glue):
    from u2seg_torch.models.roi_heads import fast_rcnn_inference

    g = glue
    score_th, nms_th, topk, H, W = g["frcnn.params"]
    boxes = torch.from_numpy(g["frcnn.in.boxes"])[None]
    probs = torch.from_numpy(g["frcnn.in.probs"])[None]
    det = fast_rcnn_inference(
        boxes, probs, torch.ones(boxes.shape[:2], dtype=torch.bool),
        torch.tensor([[int(H), int(W)]], dtype=torch.int32),
        float(score_th), float(nms_th), int(topk))
    dv = det.valid[0].numpy()
    assert dv.sum() == len(g["frcnn.out.boxes"])
    np.testing.assert_allclose(det.scores[0].numpy()[dv], g["frcnn.out.scores"],
                               rtol=1e-6)
    np.testing.assert_array_equal(det.classes[0].numpy()[dv], g["frcnn.out.classes"])
    np.testing.assert_allclose(det.boxes[0].numpy()[dv], g["frcnn.out.boxes"],
                               rtol=1e-5, atol=1e-4)


def test_mask_paste_matches_golden(glue):
    from u2seg_torch.ops.mask_paste import paste_masks

    ref = glue["paste.out.masks"].astype(bool)
    h, w = ref.shape[1:]
    got = paste_masks(torch.from_numpy(glue["paste.in.mask_probs"]),
                      torch.from_numpy(glue["paste.in.boxes"]), h, w) >= 0.5
    assert (got.numpy() != ref).sum() <= 2


def test_panoptic_fusion_matches_jax_on_golden_inputs(glue):
    """The fusion golden's inputs through both packages' stride-4 fusion
    (the golden's own outputs are a full-resolution render, which the
    eval path of a later slice ports)."""
    from u2seg_tpu.models.panoptic_fpn import combine_semantic_and_instance as jfuse
    from u2seg_tpu.structures.instances import Detections as JDet
    from u2seg_torch.models.panoptic_fpn import combine_semantic_and_instance as tfuse
    from u2seg_torch.structures.instances import Detections as TDet

    g = glue
    overlap_th, stuff_area, conf_th, H, W = g["fusion.params"]
    arrays = dict(
        boxes=g["fusion.in.boxes"][None], scores=g["fusion.in.scores"][None],
        classes=g["fusion.in.classes"].astype(np.int32)[None],
        valid=np.ones((1, len(g["fusion.in.scores"])), bool),
        mask_logits=g["fusion.in.mask_logits"][None])
    sem = g["fusion.in.sem_logits"][None]
    sizes = np.array([[int(H), int(W)]], np.int32)
    kw = dict(instance_conf_thresh=float(conf_th), overlap_thresh=float(overlap_th),
              stuff_area_limit=int(stuff_area))
    ref = jfuse(JDet(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                jnp.asarray(sem), jnp.asarray(sizes), **kw)
    got = tfuse(TDet(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
                torch.from_numpy(sem), torch.from_numpy(sizes), **kw)
    assert int(np.asarray(ref[4]).sum()) > 1
    for name, r, t in zip(["panoptic", "category", "is_thing", "score",
                           "valid", "instance_idx"], ref, got):
        if name == "score":
            close(t, r)
        else:
            exact(t, r)
