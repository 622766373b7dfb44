"""The plain versions of the ROIAlign backward kernel vs the JAX package.

The port's backward kernel (CUDA) is held on the card against autograd of
``multilevel_roi_align_ref``; here its plain versions are held against the
JAX package on the CPU:

(a) ``jax.grad`` of the JAX ``multilevel_roi_align_ref`` w.r.t. the real
    levels (the virtual level's gradient arrives through the 2x average
    pool);
(b) ``_ml_bwd_features``, the JAX package's plain reference of its Pallas
    backward kernel, w.r.t. the EXTENDED level list (virtual level last);
(c) the kernel's own algorithm in plain PyTorch,
    ``ordered_backward_reference`` (per tile, the ROIs of its routing list
    in ascending index, cut into segments of 1, 2 or ``SEGMENT`` ROIs whose
    sums are added in segment order), against ``jax.grad`` of the JAX
    ``multilevel_roi_align_train``, whose backward is the Pallas kernel
    ``_ml_bwd_kernel``, run as the JAX package's tests run it on the CPU
    (``pallas_call(interpret=True)``), and against autograd of the twin; its
    routing lists against a brute-force intersection of spans and tiles,
    and its segment plan (work items in descending ROI count, partial slots,
    folds) against a brute-force walk of those lists.

Tolerance: f32, 1e-5 * max|grad| per level (the sums run in another order).
Under ``torch.use_deterministic_algorithms(True)`` the twin and the routing
run, and two runs give the same bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2seg_tpu.ops import roi_align_pallas as jrap
from u2seg_torch.ops import roi_align_ml as rap

torch.set_num_threads(1)
STRIDES = (4, 8, 16, 32)
H, W, C, B = 96, 160, 6, 2          # p5 is 3 x 5: narrower than the window


def _levels(rng, dtype=np.float32):
    return [rng.randn(B, H // s, W // s, C).astype(dtype) for s in STRIDES]


BOXES = {
    "small": [[3.0, 5.0, 20.0, 30.0], [40.5, 12.25, 47.0, 19.5],
              [100.0, 60.0, 131.0, 90.0], [0.0, 0.0, 9.0, 7.0]],
    # SPAN_BUDGET = 28 cells: 112 px on p2, 224 on p3 -> the window-fit bump
    "budget_edge": [[4.0, 4.0, 116.0, 60.0], [4.0, 4.0, 117.0, 60.0],
                    [10.0, 2.0, 30.0, 95.0], [1.0, 1.0, 158.0, 20.0]],
    # over the budget on p5 (896 px) -> the virtual level
    "virtual": [[0.0, 0.0, 900.0, 950.0], [-300.0, -200.0, 700.0, 760.0],
                [0.0, 0.0, 2000.0, 1900.0]],
    "degenerate": [[50.0, 50.0, 50.0, 50.0], [0.0, 0.0, 0.0, 0.0],
                   [150.0, 80.0, 200.0, 120.0], [-40.0, -30.0, -5.0, -2.0]],
}


def _case(name, s):
    rng = np.random.RandomState(sorted(BOXES).index(name) + 10 * s)
    boxes = np.array(BOXES[name], np.float32)
    bidx = rng.randint(0, B, len(boxes)).astype(np.int32)
    g = rng.randn(len(boxes), s, s, C).astype(np.float32)
    return _levels(rng), boxes, bidx, g


def _close(got, ref, what):
    ref = np.asarray(ref)
    tol = 1e-5 * max(float(np.abs(ref).max()), 1e-30)
    assert got.shape == ref.shape, what
    assert float(np.abs(got.detach().numpy() - ref).max()) <= tol, what


@pytest.mark.parametrize("s", [7, 14])
@pytest.mark.parametrize("name", sorted(BOXES))
def test_autograd_of_plain_version_matches_jax_grad(name, s):
    levels, boxes, bidx, g = _case(name, s)
    ref = jax.grad(lambda f: (jrap.multilevel_roi_align_ref(
        f, jnp.asarray(boxes), jnp.asarray(bidx), s, STRIDES) * g).sum())(
            [jnp.asarray(l) for l in levels])
    feats = [torch.from_numpy(l).requires_grad_() for l in levels]
    out = rap.multilevel_roi_align_train(
        feats, torch.from_numpy(boxes), torch.from_numpy(bidx), s, STRIDES)
    assert out.dtype == torch.float32
    got = torch.autograd.grad(out, feats, torch.from_numpy(g))
    if name == "virtual":
        assert float(got[3].abs().max()) > 0 and float(got[0].abs().max()) == 0
    for lvl, (a, b) in enumerate(zip(got, ref)):
        _close(a, b, f"{name} s={s} level {lvl}")


@pytest.mark.parametrize("s", [7, 14])
@pytest.mark.parametrize("name", sorted(BOXES))
def test_autograd_of_plain_version_matches_ml_bwd_features(name, s):
    levels, boxes, bidx, g = _case(name, s)
    jext, jstrides = jrap._append_virtual_level(
        [jnp.asarray(l) for l in levels], STRIDES)
    ref = jrap._ml_bwd_features(
        jnp.asarray(g), jnp.asarray(boxes), jnp.asarray(bidx),
        tuple(tuple(f.shape) for f in jext), jnp.float32, s, tuple(jstrides),
        2, 224.0, 4)
    ext, strides = rap._append_virtual_level(
        [torch.from_numpy(l) for l in levels], STRIDES)
    for a, b in zip(ext, jext):                      # the virtual level itself
        _close(a, b, "virtual level")
    ext = [f.detach().requires_grad_() for f in ext]
    out = rap._ref_ext(ext, torch.from_numpy(boxes), torch.from_numpy(bidx),
                       s, strides, 2, 224.0, 4)
    got = torch.autograd.grad(out, ext, torch.from_numpy(g), allow_unused=True)
    assert len(got) == len(ref) == 5
    for lvl, (a, b) in enumerate(zip(got, ref)):
        _close(a, b, f"{name} s={s} extended level {lvl}")
    if name == "virtual":
        assert float(got[4].abs().max()) > 0


def test_bf16_levels_get_bf16_gradients_and_f32_output():
    levels, boxes, bidx, g = _case("small", 7)
    feats = [torch.from_numpy(l).bfloat16().requires_grad_() for l in levels]
    out = rap.multilevel_roi_align_train(
        feats, torch.from_numpy(boxes), torch.from_numpy(bidx), 7, STRIDES)
    assert out.dtype == torch.float32
    got = torch.autograd.grad(out, feats, torch.from_numpy(g))
    assert all(t.dtype == torch.bfloat16 and t.shape == f.shape
               for t, f in zip(got, feats))
    ref = jrap._ml_bwd_features(
        jnp.asarray(g), jnp.asarray(boxes), jnp.asarray(bidx),
        tuple(tuple(f.shape) for f in jrap._append_virtual_level(
            [jnp.asarray(l) for l in levels], STRIDES)[0]),
        jnp.float32, 7, STRIDES + (64,), 2, 224.0, 4)
    # one bf16 rounding of an f32 sum: 2^-8 relative
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b), rtol=0.01,
                                   atol=0.01 * float(np.abs(b).max()))


def test_no_rois_gives_zero_gradients():
    levels, boxes, bidx, g = _case("small", 7)
    feats = [torch.from_numpy(l).requires_grad_() for l in levels]
    out = rap.multilevel_roi_align_train(
        feats, torch.from_numpy(boxes[:0]), torch.from_numpy(bidx[:0]), 7, STRIDES)
    assert out.shape == (0, 7, 7, C)
    got = torch.autograd.grad(out, feats, torch.from_numpy(g[:0]))
    assert all(float(t.abs().max()) == 0 for t in got)


def test_gradient_reaches_channels_last_nchw_maps():
    """The model hands the pooler NHWC views of NCHW channels-last maps; the
    gradient must come back on the NCHW leaf."""
    levels, boxes, bidx, g = _case("small", 7)
    leaves = [torch.from_numpy(l).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_() for l in levels]
    views = [t.permute(0, 2, 3, 1) for t in leaves]
    assert all(v.is_contiguous() for v in views)
    out = rap.multilevel_roi_align_train(
        views, torch.from_numpy(boxes), torch.from_numpy(bidx), 7, STRIDES)
    (out * torch.from_numpy(g)).sum().backward()
    feats = [torch.from_numpy(l).requires_grad_() for l in levels]
    ref = torch.autograd.grad(rap.multilevel_roi_align_ref(
        feats, torch.from_numpy(boxes), torch.from_numpy(bidx), 7, STRIDES),
        feats, torch.from_numpy(g))
    for leaf, r in zip(leaves, ref):
        assert leaf.grad.shape == leaf.shape
        _close(leaf.grad.permute(0, 2, 3, 1), r.numpy(), "nchw leaf")


def _routing_case(name, s):
    """The extended levels, the kernel's ROI tables and the shapes."""
    levels, boxes, bidx, g = _case(name, s)
    ext, strides = rap._append_virtual_level([torch.from_numpy(l) for l in levels],
                                             STRIDES)
    fa = rap._prepare_ext(ext, torch.from_numpy(boxes), torch.from_numpy(bidx), s, 2,
                          strides, 224.0, 4, torch.float32)
    return ext, strides, fa, [tuple(f.shape) for f in ext], boxes, bidx, g


@pytest.mark.parametrize("s", [7, 14])
@pytest.mark.parametrize("name", sorted(BOXES))
def test_routing_lists_equal_a_brute_force_intersection(name, s):
    """Tile t of ``backward_routing`` lists, in ascending index, every ROI on
    its level and image whose span widened by one cell meets the tile's
    8 x 8 cells; the span here comes from the twin's per-sample weights
    (``_ml_geometry``), the tiles are enumerated one by one."""
    ext, strides, fa, shapes, boxes, bidx, _ = _routing_case(name, s)
    starts, rois, _ = rap.backward_routing(fa.roi_i, fa.roi_f, shapes, s, 2)
    dims = tuple(sh[1:3] for sh in shapes)
    wy, wx, _, prep, _ = rap._ml_geometry(torch.from_numpy(boxes), torch.from_numpy(bidx),
                                          dims, strides, s, 2, 224.0, 4)
    ys, xs = (wy.numpy() != 0).any(1), (wx.numpy() != 0).any(1)
    lvl, oy, ox = prep["lvl"].numpy(), prep["oy"].numpy(), prep["ox"].numpy()
    t = rap.BACKWARD_TILE
    expected = []
    for level, (_, h, w, _) in enumerate(shapes):
        for b in range(B):
            for y0 in range(0, h, t):
                for x0 in range(0, w, t):
                    hit = []
                    for roi in range(len(boxes)):
                        cy, cx = np.flatnonzero(ys[roi]), np.flatnonzero(xs[roi])
                        if lvl[roi] != level or bidx[roi] != b or not (len(cy) and len(cx)):
                            continue
                        y_lo, y_hi = max(oy[roi] + cy[0] - 1, 0), min(oy[roi] + cy[-1] + 1, h - 1)
                        x_lo, x_hi = max(ox[roi] + cx[0] - 1, 0), min(ox[roi] + cx[-1] + 1, w - 1)
                        if y_lo < y0 + t and y_hi >= y0 and x_lo < x0 + t and x_hi >= x0:
                            hit.append(roi)
                    expected.append(hit)
    starts, rois = starts.tolist(), rois.tolist()
    assert len(starts) == len(expected) + 1 and starts[0] == 0
    got = [rois[a:b] for a, b in zip(starts, starts[1:])]
    assert got == expected
    assert sum(map(len, got)) > 0


@pytest.fixture
def interpret_mode(monkeypatch):
    """The Pallas kernels in interpret mode, as the JAX package's tests run
    them on the CPU."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


@pytest.mark.parametrize("segment", [1, 2, rap.SEGMENT])
@pytest.mark.parametrize("s", [7, 14])
@pytest.mark.parametrize("name", sorted(BOXES))
def test_segment_plan_holds_every_pair_once_in_order(name, s, segment):
    """The plan of ``backward_routing``: every tile has items; the items of a
    tile, by list position, hold its list exactly once, each a run of at most
    ``segment`` consecutive ROIs in ascending index, all but the last full;
    items come in descending ROI count, ties by tile, then position; segment
    0 stores into the gradient (slot -1), the others into partial slots
    numbered in tile order, and one fold per cut tile names them."""
    ext, strides, fa, shapes, boxes, bidx, _ = _routing_case(name, s)
    starts, rois, plan = rap.backward_routing(fa.roi_i, fa.roi_f, shapes, s, 2, segment)
    starts, rois = starts.tolist(), rois.tolist()
    items, folds = plan.items.tolist(), plan.folds.tolist()
    order = [(-count, tile, first) for tile, first, count, _ in items]
    assert order == sorted(order)
    by_tile = {}
    for tile, first, count, slot in items:
        by_tile.setdefault(tile, []).append((first, count, slot))
    assert sorted(by_tile) == list(range(len(starts) - 1))
    expected_folds, next_slot, cut = [], 0, 0
    for tile in range(len(starts) - 1):
        segs = sorted(by_tile[tile])
        listed = rois[starts[tile]:starts[tile + 1]]
        assert [r for first, count, _ in segs for r in rois[first:first + count]] == listed
        assert segs[0][0] == starts[tile] and all(
            a[0] + a[1] == b[0] for a, b in zip(segs, segs[1:]))
        assert all(count == segment for _, count, _ in segs[:-1])
        assert 0 <= segs[-1][1] <= segment and (segs[-1][1] > 0 or not listed)
        assert listed == sorted(set(listed))
        assert [slot for _, _, slot in segs] == [-1] + list(
            range(next_slot, next_slot + len(segs) - 1))
        if len(segs) > 1:
            expected_folds.append([tile, next_slot, len(segs) - 1])
            next_slot += len(segs) - 1
            cut += 1
    assert folds == expected_folds
    assert cut == sum(b - a > segment for a, b in zip(starts, starts[1:]))


def _ordered_reference_case(name, s, segment):
    ext, strides, fa, shapes, boxes, bidx, g = _routing_case(name, s)
    got = rap.ordered_backward_reference(torch.from_numpy(g), fa.roi_i, fa.roi_f, shapes,
                                         s, 2, segment)
    assert all(a.dtype == torch.float32 and tuple(a.shape) == sh
               for a, sh in zip(got, shapes))
    leaves = [f.detach().requires_grad_() for f in ext]
    twin = torch.autograd.grad(
        rap._ref_ext(leaves, torch.from_numpy(boxes), torch.from_numpy(bidx), s, strides,
                     2, 224.0, 4), leaves, torch.from_numpy(g))
    for lvl, (a, b) in enumerate(zip(got, twin)):
        _close(a, b.numpy(), f"{name} s={s} twin, extended level {lvl}")
    levels = [jnp.asarray(f.numpy()) for f in ext[:4]]
    ref = jax.grad(lambda f: (jrap.multilevel_roi_align_train(
        f, jnp.asarray(boxes), jnp.asarray(bidx), s, STRIDES) * g).sum())(levels)
    # the real levels' gradients: the kernel's, plus the virtual level's
    # carried back through the 2x average pool by autograd on both sides
    real = [f.detach().requires_grad_() for f in ext[:4]]
    ext2, _ = rap._append_virtual_level(real, STRIDES)
    full = torch.autograd.grad(ext2, real, got, allow_unused=True)
    for lvl, (a, b) in enumerate(zip(full, ref)):
        _close(a, b, f"{name} s={s} JAX train pooler, level {lvl}")
    if name == "virtual":
        assert float(got[4].abs().max()) > 0


@pytest.mark.parametrize("s", [7, 14])
@pytest.mark.parametrize("name", sorted(BOXES))
def test_ordered_reference_matches_the_pallas_backward_and_autograd(name, s, interpret_mode):
    _ordered_reference_case(name, s, rap.SEGMENT)


@pytest.mark.parametrize("segment", [1, 2])
@pytest.mark.parametrize("s", [7, 14])
@pytest.mark.parametrize("name", sorted(BOXES))
def test_ordered_reference_in_short_segments_matches_the_pallas_backward(
        name, s, segment, interpret_mode):
    """Segments of 1 and 2 ROIs: most tiles with a list are cut, so the
    partial slots and the fold carry the sums."""
    _ordered_reference_case(name, s, segment)


def test_ordered_reference_with_no_rois_gives_zeros():
    ext, strides, fa, shapes, boxes, bidx, g = _routing_case("virtual", 7)
    starts, rois, plan = rap.backward_routing(fa.roi_i[:0], fa.roi_f[:0], shapes, 7, 2)
    assert rois.numel() == 0 and int(starts.abs().max()) == 0
    n_tiles = rap.backward_tiles(shapes)[1][-1]            # one empty item per tile
    assert plan.items.tolist() == [[t, 0, 0, -1] for t in range(n_tiles)]
    assert plan.folds.numel() == 0
    got = rap.ordered_backward_reference(torch.from_numpy(g[:0]), fa.roi_i[:0],
                                         fa.roi_f[:0], shapes, 7, 2)
    assert [tuple(t.shape) for t in got] == shapes
    assert all(float(t.abs().max()) == 0 for t in got)


def test_deterministic_mode_runs_the_twin_and_the_routing_bit_for_bit():
    """Under torch's deterministic mode the train pooler's twin (forward and
    backward, the CPU path) and the backward's routing run without raising,
    and two runs give the same bits."""
    rng = np.random.RandomState(4)
    levels = _levels(rng)
    boxes = torch.tensor(BOXES["budget_edge"] + BOXES["virtual"])
    bidx = torch.tensor([0, 1, 1, 0, 1, 0, 1], dtype=torch.int32)
    g = torch.from_numpy(rng.randn(len(boxes), 7, 7, C).astype(np.float32))
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for _ in range(2):
            feats = [torch.from_numpy(f).requires_grad_() for f in levels]
            out = rap.multilevel_roi_align_train(feats, boxes, bidx, 7, STRIDES)
            grads = torch.autograd.grad(out, feats, g)
            ext, strides = rap._append_virtual_level([f.detach() for f in feats], STRIDES)
            fa = rap._prepare_ext(ext, boxes, bidx, 7, 2, strides, 224.0, 4, torch.float32)
            routing = rap.backward_routing(fa.roi_i, fa.roi_f, [tuple(f.shape) for f in ext],
                                           7, 2)
            runs.append((out.detach(), grads, routing))
    finally:
        torch.use_deterministic_algorithms(before)
    (o1, g1, r1), (o2, g2, r2) = runs
    assert torch.equal(o1, o2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert torch.equal(r1[0], r2[0]) and torch.equal(r1[1], r2[1])
    assert torch.equal(r1[2].items, r2[2].items) and torch.equal(r1[2].folds, r2[2].folds)
    assert float(sum(t.abs().sum() for t in g1)) > 0
