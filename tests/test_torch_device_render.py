"""u2seg_torch.engine.device_render vs the JAX package's device render and
vs the port's host oracle (engine/panoptic_render.py), function by function.

Inputs come from numpy seeds and go through both frameworks on the CPU at
small sizes. Tolerances: weight matrices and resized images are f32 products
of the same formulas, held to 1e-5 (rtol and atol; the two frameworks sum in
other orders); discrete outputs (runs, maps, segment tables, fallback flags)
are exact on the well-conditioned cases (no argmax / 0.5-threshold ties);
the fetch buffer is byte-for-byte equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2seg_tpu.engine import device_render as jdr
from u2seg_tpu.engine import panoptic_render as jpr
from u2seg_torch.engine import device_render as dr
from u2seg_torch.engine import panoptic_render as pr

torch.set_num_threads(1)


def t(x, dtype=None):
    out = torch.from_numpy(np.ascontiguousarray(x))
    return out if dtype is None else out.to(dtype)


def fields(r) -> dict:
    return {f.name: np.asarray(getattr(r, f.name))
            for f in dataclasses.fields(r)}


# ---------------------------------------------------------------------------
# weights, resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ih,oh", [(30, 22), (16, 40), (32, 32), (40, 31)])
def test_sem_resize_weights_match_jax(ih, oh):
    ref = np.asarray(jdr.sem_resize_weights(48, 10, 4, jnp.int32(ih), jnp.int32(oh)))
    got = dr.sem_resize_weights(48, 10, 4, torch.tensor(ih), torch.tensor(oh))
    assert got.shape == ref.shape == (48, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ih,iw,oh,ow", [
    (30, 40, 22, 31), (16, 20, 40, 52), (32, 40, 32, 40)])
def test_sem_chain_matches_both_host_oracles(ih, iw, oh, ow):
    """Composed weights applied to logits == the port's numpy two-stage
    chain == the JAX package's OpenCV chain (1e-5)."""
    rng = np.random.RandomState(2)
    h4, w4, c = 8, 10, 5
    logits = rng.randn(h4, w4, c).astype(np.float32)
    wy = dr.sem_resize_weights(48, h4, 4, torch.tensor(ih), torch.tensor(oh))
    wx = dr.sem_resize_weights(56, w4, 4, torch.tensor(iw), torch.tensor(ow))
    full = torch.einsum("ip,pqc,jq->ijc", wy, t(logits), wx).numpy()[:oh, :ow]
    np.testing.assert_allclose(
        full, pr.sem_seg_probs_full_res(logits, (ih, iw), (oh, ow)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        full, jpr.sem_seg_probs_full_res(logits, (ih, iw), (oh, ow)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("oh,ow,ih,iw", [
    (30, 44, 46, 67), (50, 40, 25, 20), (32, 32, 32, 32)])
def test_resize_image_device_matches_jax(oh, ow, ih, iw):
    rng = np.random.RandomState(0)
    raw = np.zeros((64, 64, 3), np.uint8)
    raw[:oh, :ow] = (rng.rand(oh, ow, 3) * 255).astype(np.uint8)
    ref = np.asarray(jdr.resize_image_device(
        jnp.asarray(raw), jnp.asarray([oh, ow], jnp.int32),
        jnp.asarray([ih, iw], jnp.int32), (72, 80)))
    got = dr.resize_image_device(
        t(raw), torch.tensor([oh, ow], dtype=torch.int32),
        torch.tensor([ih, iw], dtype=torch.int32), (72, 80)).numpy()
    assert got.shape == ref.shape == (72, 80, 3)
    # pixel values up to 255: 1e-5 relative, 1e-3 absolute
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    assert np.all(got[ih:] == 0) and np.all(got[:, iw:] == 0)


# ---------------------------------------------------------------------------
# RLE
# ---------------------------------------------------------------------------

def _rle_both(flat, max_runs):
    js, jv, jn = jdr.rle_encode(jnp.asarray(flat), max_runs)
    s, v, n = dr.rle_encode(t(flat), max_runs)
    assert s.dtype == v.dtype == n.dtype == torch.int32
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert int(n) == int(jn)
    return s.numpy(), v.numpy(), int(n)


def test_rle_round_trip():
    rng = np.random.RandomState(0)
    flat = np.repeat(rng.randint(0, 7, 40), rng.randint(1, 9, 40)).astype(np.int32)
    s, v, n = _rle_both(flat, 128)
    assert n <= 128 and not s[n:].any() and not v[n:].any()
    np.testing.assert_array_equal(dr.rle_decode(s, v, n, len(flat)), flat)


def test_rle_single_run():
    flat = np.zeros(100, np.int32)
    s, v, n = _rle_both(flat, 8)
    assert n == 1
    np.testing.assert_array_equal(dr.rle_decode(s, v, n, 100), flat)


def test_rle_overflow_is_counted_and_the_budget_kept():
    flat = np.arange(50, dtype=np.int32)     # 50 runs into a budget of 16
    s, v, n = _rle_both(flat, 16)
    assert n == 50
    np.testing.assert_array_equal(s, np.arange(16))
    np.testing.assert_array_equal(v, np.arange(16))


def test_rle_batched_along_the_last_axis():
    rng = np.random.RandomState(1)
    flat = rng.randint(0, 3, (4, 64)).astype(np.int32)
    s, v, n = dr.rle_encode(t(flat), 64)
    assert s.shape == (4, 64) and n.shape == (4,)
    for b in range(4):
        s1, v1, n1 = dr.rle_encode(t(flat[b]), 64)
        assert torch.equal(s[b], s1) and torch.equal(v[b], v1) and n[b] == n1
        np.testing.assert_array_equal(
            dr.rle_decode(s[b].numpy(), v[b].numpy(), int(n[b]), 64), flat[b])


# ---------------------------------------------------------------------------
# full render
# ---------------------------------------------------------------------------

def make_case(seed=0, k=12, m=14, h4=12, w4=16, c=6,
              ih=44, iw=60, oh=36, ow=50):
    """Well-separated synthetic detections + sem logits (no ties): the cases
    of the JAX package's own device-render test."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((k, 4), np.float32)
    xy = rng.rand(k, 2) * [iw * 0.6, ih * 0.6]
    wh = rng.rand(k, 2) * [iw * 0.35, ih * 0.35] + 6
    boxes[:, :2] = xy
    boxes[:, 2:] = xy + wh
    scores = np.sort(rng.rand(k).astype(np.float32))[::-1] * 0.6 + 0.35
    scores[k // 2:] = rng.rand(k - k // 2) * 0.3  # below conf thresh
    classes = rng.randint(0, 9, k).astype(np.int32)
    valid = np.ones(k, bool)
    valid[-1] = False
    mask_logits = rng.randn(k, m, m).astype(np.float32) * 4  # away from 0
    sem_logits = rng.randn(h4, w4, c).astype(np.float32) * 3
    return (boxes, scores, classes, valid, mask_logits, sem_logits,
            (ih, iw), (oh, ow))


CANVAS = (40, 56)
KW = dict(k_fuse=10, max_runs=4096, instance_conf_thresh=0.5,
          overlap_thresh=0.5, stuff_area_limit=40)


def run_port(case):
    *arrays, ihw, ohw = case
    r = dr.render_image(*[t(a) for a in arrays],
                        torch.tensor(ihw, dtype=torch.int32),
                        torch.tensor(ohw, dtype=torch.int32),
                        canvas=CANVAS, **KW)
    out = fields(r)
    out["det_valid"] = case[3]
    return out


_jax_render = jax.jit(lambda *a: jdr.render_image(*a, canvas=CANVAS, **KW))


def run_jax(case):
    *arrays, ihw, ohw = case
    r = _jax_render(*[jnp.asarray(a) for a in arrays],
                    jnp.asarray(ihw, jnp.int32), jnp.asarray(ohw, jnp.int32))
    return fields(r)


def run_host(case):
    *arrays, ihw, ohw = case
    return pr.render_panoptic_output(
        *arrays, ihw, ohw,
        instance_conf_thresh=KW["instance_conf_thresh"],
        overlap_thresh=KW["overlap_thresh"],
        stuff_area_limit=KW["stuff_area_limit"])


def assert_same_segments(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a["id"] == b["id"] and a["isthing"] == b["isthing"]
        assert a["category_id"] == b["category_id"]
        if a["isthing"]:
            assert a["instance_id"] == b["instance_id"]
            np.testing.assert_allclose(a["score"], b["score"], rtol=1e-6)
        else:
            assert a["area"] == b["area"]


def assert_same_render(got: dict, ref: dict):
    """Every RenderedImage field of the port == the JAX package's."""
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape, name
        if r.dtype.kind == "f":
            np.testing.assert_allclose(g, r, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)


def no_detections(case):
    boxes, scores, *rest = case
    return (boxes, scores * 0.0, *rest)


CASES = {
    "seed0": make_case(seed=0), "seed3": make_case(seed=3),
    "seed7": make_case(seed=7), "seed11": make_case(seed=11),
    "no_detections": no_detections(make_case(seed=5)),
    "upscale": make_case(seed=2, ih=30, iw=44, oh=40, ow=56),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_render_image_matches_jax(name):
    case = CASES[name]
    got = run_port(case)
    assert not bool(got["fallback"])
    assert_same_render(got, run_jax(case))


@pytest.mark.parametrize("name", sorted(CASES))
def test_render_image_matches_host_oracle(name):
    case = CASES[name]
    got = run_port(case)
    sem_d, pan_d, segs_d = dr.decode_rendered_image(got, CANVAS, case[-1])
    sem_h, pan_h, segs_h = run_host(case)
    np.testing.assert_array_equal(sem_d, sem_h)
    np.testing.assert_array_equal(pan_d, pan_h)
    assert_same_segments(segs_d, segs_h)
    if name == "no_detections":
        assert segs_d and all(not s["isthing"] for s in segs_d)
    elif name.startswith("seed"):
        assert any(s["isthing"] for s in segs_d) and any(
            not s["isthing"] for s in segs_d)


def test_host_oracle_matches_the_jax_packages():
    """The port's numpy oracle (own bilinear resize) == the JAX package's
    (OpenCV resize) on the same case: maps and segment tables exact."""
    case = CASES["seed3"]
    *arrays, ihw, ohw = case
    sem_j, pan_j, segs_j = jpr.render_panoptic_output(
        *arrays, ihw, ohw, instance_conf_thresh=0.5, overlap_thresh=0.5,
        stuff_area_limit=40)
    sem_h, pan_h, segs_h = run_host(case)
    np.testing.assert_array_equal(sem_h, sem_j)
    np.testing.assert_array_equal(pan_h, pan_j)
    assert_same_segments(segs_h, segs_j)


def test_fallback_flags():
    case = make_case()
    big = case[:-1] + ((CANVAS[0] + 8, CANVAS[1]),)
    assert bool(run_port(big)["fallback"])          # exceeds the canvas
    boxes, scores, classes, valid, ml, sl, ihw, ohw = case
    many = (boxes, np.full_like(scores, 0.9), classes, np.ones_like(valid),
            ml, sl, ihw, ohw)
    assert bool(run_port(many)["fallback"])         # exceeds the fusion budget
    *arrays, ihw, ohw = case
    tight = dr.render_image(*[t(a) for a in arrays],
                            torch.tensor(ihw, dtype=torch.int32),
                            torch.tensor(ohw, dtype=torch.int32),
                            canvas=CANVAS, **{**KW, "max_runs": 16})
    assert bool(tight.fallback)                     # exceeds the run budget


# ---------------------------------------------------------------------------
# batch render, packing, the fetch buffer
# ---------------------------------------------------------------------------

def _batch(names):
    from u2seg_torch.structures.instances import Detections

    cases = [CASES[n] for n in names]
    stack = lambda i, dt=None: t(np.stack([c[i] for c in cases]), dt)
    det = Detections(stack(0), stack(1), stack(2), stack(3), stack(4))
    return det, stack(5), stack(6, torch.int32), stack(7, torch.int32), cases


def test_render_batch_equals_per_image_renders():
    det, sem, sizes, osizes, cases = _batch(["seed0", "no_detections", "seed7"])
    r = dr.render_batch(det, sem, sizes, osizes, canvas=CANVAS, **KW)
    for b, case in enumerate(cases):
        one = run_port(case)
        for name, v in fields(r).items():
            np.testing.assert_array_equal(v[b], one[name], err_msg=name)


def _jax_batch(det, sem, sizes, osizes, prefix):
    from u2seg_tpu.structures.instances import Detections as JDet

    jdet = JDet(*[jnp.asarray(getattr(det, f).numpy()) for f in
                  ("boxes", "scores", "classes", "valid", "mask_logits")])

    def fn(d, s, hw, ohw):
        packed = jdr.pack_rendered_batch(
            jdr.render_batch(d, s, hw, ohw, canvas=CANVAS, **KW), prefix=prefix)
        small = {"boxes": d.boxes, "scores": d.scores, "classes": d.classes,
                 "valid": d.valid}
        return packed, jdr.pack_fetch_buffer(packed, small)

    return jax.jit(fn)(jdet, jnp.asarray(sem.numpy()),
                       jnp.asarray(sizes.numpy()), jnp.asarray(osizes.numpy()))


def test_pack_and_fetch_buffer_are_byte_identical_to_jax():
    """render_batch -> pack_rendered_batch -> pack_fetch_buffer on the same
    inputs: every packed field equal, the uint8 buffer byte for byte (the
    f32 score fields are copies of the inputs, so they are exact too), and
    unpack + decode reproduce the host oracle."""
    det, sem, sizes, osizes, cases = _batch(["seed0", "seed3", "seed11"])
    prefix = 3 * 1500
    jpacked, jbuf = _jax_batch(det, sem, sizes, osizes, prefix)
    packed = dr.pack_rendered_batch(
        dr.render_batch(det, sem, sizes, osizes, canvas=CANVAS, **KW),
        prefix=prefix)
    for name, ref in fields(jpacked).items():
        got = getattr(packed, name).numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    small = {"boxes": det.boxes, "scores": det.scores, "classes": det.classes,
             "valid": det.valid}
    buf = dr.pack_fetch_buffer(packed, small)
    assert buf.dtype == torch.uint8 and buf.dim() == 1
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))

    layout = dr.fetch_layout(3, 12, KW["k_fuse"], 6, prefix)
    assert layout == jdr.fetch_layout(3, 12, KW["k_fuse"], 6, prefix)
    # the port's reader takes the JAX package's buffer and its own alike
    for raw in (buf.numpy(), np.asarray(jbuf)):
        rend = dr.unpack_fetch_buffer(raw, layout)
        offs = rend["offs"].astype(np.int64)
        assert int(offs[-1]) <= prefix
        for i, case in enumerate(cases):
            p0, p1, p2 = offs[2 * i:2 * i + 3]
            r = {k: rend[k][i] for k in ("takes", "order", "sorted_scores",
                                         "sorted_classes", "stuff_ok",
                                         "stuff_area", "det_valid")}
            r.update(pan_starts=rend["starts"][p0:p1], pan_values=rend["values"][p0:p1],
                     pan_nruns=p1 - p0, sem_starts=rend["starts"][p1:p2],
                     sem_values=rend["values"][p1:p2], sem_nruns=p2 - p1)
            sem_d, pan_d, segs_d = dr.decode_rendered_image(r, CANVAS, case[-1])
            sem_h, pan_h, segs_h = run_host(case)
            np.testing.assert_array_equal(sem_d, sem_h)
            np.testing.assert_array_equal(pan_d, pan_h)
            assert_same_segments(segs_d, segs_h)


def test_pack_rendered_batch_drops_runs_past_the_budget():
    """An image with more runs than max_runs packs exactly max_runs of them
    and nothing leaks into its neighbours' slots."""
    rng = np.random.RandomState(7)
    bsz, max_runs, n = 3, 16, 200
    flats = [np.pad(np.repeat(rng.randint(0, 5, 40), rng.randint(1, 11, 40)),
                    (0, n), mode="edge")[:n].astype(np.int32)
             for _ in range(2 * bsz)]
    enc = [dr.rle_encode(t(f), max_runs) for f in flats]
    jenc = [jdr.rle_encode(jnp.asarray(f), max_runs) for f in flats]
    assert max(int(e[2]) for e in enc) > max_runs
    kf, c = 4, 5

    def rendered(mod, xp, enc, bool_, i32):
        col = lambda first, k: xp.stack([enc[2 * b + first][k] for b in range(bsz)])
        return mod.RenderedImage(
            pan_starts=col(0, 0), pan_values=col(0, 1), pan_nruns=col(0, 2),
            sem_starts=col(1, 0), sem_values=col(1, 1), sem_nruns=col(1, 2),
            takes=xp.zeros((bsz, kf), dtype=bool_),
            order=xp.zeros((bsz, kf), dtype=i32),
            sorted_scores=xp.zeros((bsz, kf)),
            sorted_classes=xp.zeros((bsz, kf), dtype=i32),
            stuff_ok=xp.zeros((bsz, c), dtype=bool_),
            stuff_area=xp.zeros((bsz, c), dtype=i32),
            fallback=xp.zeros((bsz,), dtype=bool_))

    got = dr.pack_rendered_batch(
        rendered(dr, torch, enc, torch.bool, torch.int32), prefix=8)
    ref = jdr.pack_rendered_batch(
        rendered(jdr, jnp, jenc, bool, jnp.int32), prefix=8)
    for name, r in fields(ref).items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), r, err_msg=name)
    offs = got.offs.numpy()
    assert np.diff(offs).max() == max_runs and got.starts_prefix.shape == (8,)
