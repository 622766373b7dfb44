"""What the span kernels of ``u2seg_torch/csrc/roi_align_ml.cu`` rest on,
checked on the CPU with numpy-seeded inputs.

(a) The dense-weight identity. For one ROI the pooled output is
    ``einsum(Wy, Wx, window)`` with the per-axis weights of
    ``_pooled_axis_weights_host`` (r-sample mean folded in); it equals the
    port's twin ``multilevel_roi_align_ref`` and the JAX
    ``multilevel_roi_align_ref``. Its transpose, added once per span cell,
    equals autograd of the twin. f32, 1e-4 * max(1, max|ref|): the sums run in
    another order.
(b) The span invariant. Every cell of non-zero weight lies inside the ROI's
    window and inside the true level dims, on full-size levels and on levels
    smaller than the window (2 x 2, 1 x 1), so a kernel may read and write a
    span without a bounds test; a box within the routing budget spans at most
    SPAN_BUDGET + 3 cells a side.
(c) The launch plan's helpers: block size and stage buffer by output size
    (nothing else sets them), shared-memory sizes, and the checks that raise.
(d) No first kernel (``_v1``) is left: the span kernels replaced them.
"""
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import u2seg_tpu.ops.roi_align_pallas as jrap
from u2seg_torch.ops import roi_align_ml as rap

torch.set_num_threads(1)
STRIDES = (4, 8, 16, 32)
FULL = (800, 1216)      # p2 200 x 304 ... p5 25 x 38, virtual 13 x 19
TINY = (64, 64)         # p2 16 x 16 ... p5 2 x 2, virtual 1 x 1
C = 8


def boundary_boxes(h, w):
    """The budget-edge cases sit at the top real level of FULL (stride 32:
    SPAN_BUDGET = 28 cells = 896 px)."""
    return np.array([
        [10.0, 20.0, 122.0, 132.0],        # sqrt-area exactly 112
        [30.0, 5.0, 254.0, 229.0],         # exactly 224
        [0.0, 0.0, 448.0, 448.0],          # exactly 448
        [5.0, 10.0, 345.0, 30.0],          # long side -> window-fit bump
        [40.0, 2.0, 60.0, 220.0],          # tall thin -> bump
        [16.0, 20.0, 912.0, 916.0],        # exactly at budget on p5
        [5.0, 3.0, 955.0, 953.0],          # over budget on p5 -> virtual level
        [0.0, 0.0, 2000.0, 1900.0],        # over budget on the virtual level
        [0.0, 0.0, 9000.0, 8000.0],        # bins taller than a stage buffer
        [50.0, 50.0, 50.0, 50.0],          # zero size
        [0.0, 0.0, 0.0, 0.0],              # zero box
        [w - 160.0, h - 110.0, w + 40.0, h + 20.0],   # past the image corner
        [w + 50.0, h + 60.0, w + 90.0, h + 100.0],    # wholly outside: no weight
        [12.5, 7.25, 44.75, 39.5],         # small, fractional
    ], np.float32)


def random_proposals(rng, n, h, w):
    cx, cy = rng.rand(n) * w, rng.rand(n) * h
    bw = np.exp(rng.uniform(np.log(8), np.log(800), n))
    bh = bw * np.exp(rng.uniform(-1.2, 1.2, n))
    b = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)
    b[:, 0::2] = b[:, 0::2].clip(0, w)
    b[:, 1::2] = b[:, 1::2].clip(0, h)
    return b.astype(np.float32)


def case(hw, seed, n_random=200, batch=2):
    rng = np.random.RandomState(seed)
    h, w = hw
    feats = [rng.randn(batch, h // st, w // st, C).astype(np.float32) for st in STRIDES]
    boxes = np.concatenate([boundary_boxes(h, w), random_proposals(rng, n_random, h, w)])
    bidx = rng.randint(0, batch, len(boxes)).astype(np.int32)
    return feats, boxes, bidx


def dense_form(feats, boxes, bidx, s, r=2):
    """Wy, Wx, the gathered windows and the flat indices, on the extended
    level list."""
    ext, strides = rap._append_virtual_level(feats, STRIDES)
    dims = tuple((f.shape[1], f.shape[2]) for f in ext)
    wy, wx, prep = rap.dense_axis_weights(boxes, dims, strides, s, r)
    _, _, idx, _, total = rap._ml_geometry(boxes, bidx, dims, strides, s, r, 224.0, 4)
    flat = rap._pad_pyramid_flat(ext, prep["pdims"])
    return ext, dims, wy, wx, prep, idx, flat, total


def tol_of(ref):
    return 1e-4 * max(1.0, float(np.abs(np.asarray(ref)).max()))


@pytest.mark.parametrize("hw", [FULL, TINY], ids=["full", "tiny"])
@pytest.mark.parametrize("s", [7, 14])
def test_dense_weight_einsum_is_the_pooler(hw, s):
    feats, boxes, bidx = case(hw, seed=s)
    tf = [torch.from_numpy(f) for f in feats]
    tb, ti = torch.from_numpy(boxes), torch.from_numpy(bidx)
    _, _, wy, wx, _, idx, flat, _ = dense_form(tf, tb, ti, s)
    got = torch.einsum("rpy,rqx,ryxc->rpqc", wy, wx, flat[idx]).numpy()
    twin = rap.multilevel_roi_align_ref(tf, tb, ti, s, STRIDES).numpy()
    assert got.shape == twin.shape == (len(boxes), s, s, C)
    assert float(np.abs(got - twin).max()) <= tol_of(twin)
    ref = np.asarray(jrap.multilevel_roi_align_ref(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), jnp.asarray(bidx),
        s, STRIDES, 2))
    assert float(np.abs(got - ref).max()) <= tol_of(ref)
    # the box wholly outside the image has no weight at all and pools zeros
    assert float(np.abs(got[12]).max()) == 0.0 and float(np.abs(ref[12]).max()) == 0.0


@pytest.mark.parametrize("hw", [FULL, TINY], ids=["full", "tiny"])
@pytest.mark.parametrize("s", [7, 14])
def test_transposed_einsum_added_once_per_span_cell_is_the_gradient(hw, s):
    feats, boxes, bidx = case(hw, seed=10 + s)
    tb, ti = torch.from_numpy(boxes), torch.from_numpy(bidx)
    g = torch.from_numpy(np.random.RandomState(s).randn(
        len(boxes), s, s, C).astype(np.float32))
    ext, dims, wy, wx, prep, idx, _, total = dense_form(
        [torch.from_numpy(f) for f in feats], tb, ti, s)
    # what the backward kernel adds: one value per (span cell, channel)
    gw = torch.einsum("rpy,rqx,rpqc->ryxc", wy, wx, g)
    sp = rap.roi_spans(wy, wx)
    ys = torch.arange(rap.WIN_Y)[None, :, None]
    xs = torch.arange(rap.WIN)[None, None, :]
    in_span = ((ys >= sp[:, 0, None, None]) & (ys <= sp[:, 1, None, None])
               & (xs >= sp[:, 2, None, None]) & (xs <= sp[:, 3, None, None]))
    assert float(gw[~in_span].abs().max()) == 0.0      # nothing falls outside a span
    batch = feats[0].shape[0]
    flat_grad = torch.zeros(batch * total, C).index_add_(
        0, idx[in_span], gw[in_span])
    flat_grad = flat_grad.reshape(batch, total, C)
    # autograd of the twin on the extended level list
    leaves = [f.detach().clone().requires_grad_() for f in ext]
    out = rap._ref_ext(leaves, tb, ti, s, STRIDES + (64,), 2, 224.0, 4)
    ref = torch.autograd.grad(out, leaves, g, allow_unused=True)
    offset = 0
    for (h, w), (ph, pw), r_l in zip(dims, prep["pdims"], ref):
        got = flat_grad[:, offset:offset + ph * pw].reshape(batch, ph, pw, C)
        offset += ph * pw
        r_l = torch.zeros(batch, h, w, C) if r_l is None else r_l
        assert float((got[:, :h, :w] - r_l).abs().max()) <= tol_of(r_l.numpy())
        # and nothing lands in the zero padding beyond the true dims
        assert float(got[:, h:].abs().max() if ph > h else 0.0) == 0.0
        assert float(got[:, :, w:].abs().max() if pw > w else 0.0) == 0.0


@pytest.mark.parametrize("hw", [FULL, TINY], ids=["full", "tiny"])
@pytest.mark.parametrize("s", [7, 14])
def test_every_nonzero_weight_lies_in_the_window_and_the_true_level(hw, s):
    feats, boxes, bidx = case(hw, seed=20 + s, n_random=400)
    tb = torch.from_numpy(boxes)
    ext, strides = rap._append_virtual_level(
        [torch.from_numpy(f) for f in feats], STRIDES)
    dims = tuple((f.shape[1], f.shape[2]) for f in ext)
    wy, wx, prep = rap.dense_axis_weights(tb, dims, strides, s, 2)
    assert wy.shape == (len(boxes), s, rap.WIN_Y) and wx.shape == (len(boxes), s, rap.WIN)
    assert float(wy.min()) >= 0.0 and float(wx.min()) >= 0.0
    sp = rap.roi_spans(wy, wx)
    lvl = prep["lvl"]
    true_h = torch.tensor([d[0] for d in dims])[lvl]
    true_w = torch.tensor([d[1] for d in dims])[lvl]
    has = (sp[:, 1] >= sp[:, 0]) & (sp[:, 3] >= sp[:, 2])
    # the box wholly outside has no weight; on the 1 x 1 level the 9000 px box has none either
    assert int(has.sum()) >= len(boxes) - 2 and not bool(has[12])
    oy, ox = prep["oy"].long(), prep["ox"].long()
    assert bool((oy >= 0).all()) and bool((ox >= 0).all()) and bool((ox % 8 == 0).all())
    # window: 0 <= cell < WIN_Y / WIN holds by the tables' shape; true dims:
    assert bool((oy + sp[:, 1] < true_h)[has].all())
    assert bool((ox + sp[:, 3] < true_w)[has].all())
    if hw == TINY:
        assert bool((sp[:, 1] - sp[:, 0] < 16).all())       # never more rows than p2 has
        assert {3, 4} <= set(lvl.tolist())                   # the 2 x 2 and 1 x 1 levels
    # each bin's rows: at most 2r cells of weight, summing to 1 when inside
    per_bin = (wy != 0).sum(-1)
    assert int(per_bin.max()) <= 4
    inside_all = wy.sum(-1)
    assert float(inside_all.max()) <= 1.0 + 1e-5
    # boxes within the routing budget: span <= budget + halo
    st = torch.tensor(strides, dtype=torch.float32)[lvl]
    long_cells = torch.maximum(tb[:, 2] - tb[:, 0], tb[:, 3] - tb[:, 1]) / st
    fits = has & (long_cells <= rap.SPAN_BUDGET)
    assert int(fits.sum()) > 300
    assert int((sp[:, 1] - sp[:, 0] + 1)[fits].max()) <= rap.SPAN_BUDGET + 3
    assert int((sp[:, 3] - sp[:, 2] + 1)[fits].max()) <= rap.SPAN_BUDGET + 3
    # the boxes over budget even on the virtual level (13 x 19 here): samples
    # beyond the level weigh 0, the others stay inside it
    if hw == FULL:
        assert lvl[[7, 8]].tolist() == [4, 4] and bool(has[[7, 8]].all())


@pytest.mark.parametrize("s", [2, 7])
def test_over_budget_boxes_collapse_onto_the_window_edge(s):
    """A virtual level larger than the window (64 x 80 for a 4096 x 5120
    image): samples of a box over the budget there clip onto the window's
    edge cell, where their weights add up, and at s=2 one bin spans more
    rows than a stage buffer of the forward kernel holds."""
    h, w = 4096, 5120
    rng = np.random.RandomState(40 + s)
    feats = [rng.randn(1, h // st, w // st, 2).astype(np.float32) for st in STRIDES]
    boxes = np.array([[0.0, 0.0, w, h], [100.0, 50.0, 5000.0, 4000.0],
                      [0.0, 0.0, 2560.0, h], [0.0, 0.0, w, 300.0],
                      [2000.0, 1000.0, 2100.0, 1090.0]], np.float32)
    bidx = np.zeros(len(boxes), np.int32)
    tf = [torch.from_numpy(f) for f in feats]
    tb, ti = torch.from_numpy(boxes), torch.from_numpy(bidx)
    _, dims, wy, wx, prep, idx, flat, _ = dense_form(tf, tb, ti, s)
    assert dims[-1] == (64, 80) and prep["lvl"].tolist() == [4, 4, 4, 4, 0]
    assert float(wy[0].max()) == 1.0                   # both samples of the last bin
    sp = rap.roi_spans(wy, wx)
    assert int(sp[0, 1]) == rap.WIN_Y - 1 and int(sp[0, 3]) == rap.WIN - 1
    cells = torch.arange(rap.WIN_Y)
    rows = (torch.where(wy[0] != 0, cells, -1).amax(-1)
            - torch.where(wy[0] != 0, cells, rap.WIN_Y).amin(-1) + 1)
    if s == 2:                          # 18 rows x 39 columns > a buffer of f32 cells
        assert (int(rows.max()) * int(sp[0, 3] - sp[0, 2] + 1)
                > rap.forward_plan(s)[1] // (rap.CHUNK * 4))
    got = torch.einsum("rpy,rqx,ryxc->rpqc", wy, wx, flat[idx]).numpy()
    twin = rap.multilevel_roi_align_ref(tf, tb, ti, s, STRIDES).numpy()
    assert float(np.abs(got - twin).max()) <= tol_of(twin)
    ref = np.asarray(jrap.multilevel_roi_align_ref(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), jnp.asarray(bidx),
        s, STRIDES, 2))
    assert float(np.abs(got - ref).max()) <= tol_of(ref)


def test_launch_plan_helpers():
    tables7 = 4 * (7 * 72 + 28 + 144)
    assert rap.table_bytes(7) == tables7
    assert rap.forward_shared_bytes(7, 24576) == 24576 + tables7
    assert rap.forward_shared_bytes(14) == rap.STAGE_BYTES + rap.table_bytes(14)
    assert rap.CHUNK == 64
    assert rap.record_bytes(7) == tables7 and tables7 % 16 == 0
    # the gather's ring: STAGES slots, each a ROI's record (128-byte aligned)
    # and rows of its cotangent's bins in whole tensor-copy boxes of 8 bins
    # (all 7 rows at s=7, 3 rows of 16 at s=14, one row of 32 at s=32),
    # behind 48 bytes a slot of mbarriers and a header, rounded up to 128
    assert (rap.STAGES, rap.SEGMENT, rap.RING_BYTES, rap.BOX_BINS) == (3, 16, 55296, 8)
    assert [rap.slot_bins(s) for s in (1, 7, 14, 32)] == [8, 56, 48, 32]
    assert rap.backward_shared_bytes(7) == 256 + 3 * (2816 + 56 * 64 * 4)
    assert rap.backward_shared_bytes(14) == 256 + 3 * (4864 + 48 * 64 * 4)
    assert rap.backward_shared_bytes(32) == 256 + 3 * (10368 + 32 * 64 * 4)
    for s in (1, 7, 14, 32):          # 3 blocks an SM of 228 KB, 1 KB reserved each
        assert 3 * (rap.backward_shared_bytes(s) + 1024) <= 233472
    assert rap.backward_slots() == 5 * 6   # tiles of 8 cells a 32 x 40 span can meet
    # the plan's bounds at the train step (R=1024 over 2860 tiles): items,
    # partial slots (64 cells of C f32 each: 126 MB at C=256) and folds
    assert rap.backward_bounds(1024, 2860) == (2860 + 1920, 1920, 1807)
    assert rap.backward_bounds(0, 2860) == (2860, 0, 0)
    assert rap.backward_layout(14) == (8, 30, rap.record_bytes(14), 16, 3, 48, 34)
    assert rap.forward_plan(7) == (128, 24576) and rap.forward_plan(14) == (256, 49152)
    for s in (7, 14, 32):
        rap.check_launch_plan(s, 2, 256, rap.backward_shared_bytes(s))
    # the launch arguments carry no plan of their own: it follows from s
    fields = {f.name for f in dataclasses.fields(rap.LaunchArgs)}
    assert fields == {"levels", "roi_i", "roi_f", "out", "s", "r"}
    fields = {f.name for f in dataclasses.fields(rap.BackwardArgs)}
    assert fields == {"g", "roi_i", "roi_f", "grads", "records", "spans", "words",
                      "tile_count", "tile_start", "lists", "items", "folds", "counts",
                      "partials", "s", "r"}


@pytest.mark.parametrize("s", [1, 2, 7, 8, 9, 14, 28, 64])
def test_forward_plan_is_one_the_source_takes(s):
    """What ``span_args_ok`` and ``launch_forward`` of the source require of
    the block size and the stage buffer, for every output size."""
    threads, stage = rap.forward_plan(s)
    assert threads % 32 == 0 and max(32, 2 * s) <= threads <= 256
    assert stage % rap.ALIGN == 0 and stage <= rap.STAGE_BYTES
    assert stage >= rap.WIN * rap.CHUNK * 4            # a row of the widest span, f32
    if s <= 14:                                        # the model's sizes: 4 blocks an SM
        assert rap.forward_shared_bytes(s, stage) <= rap.MAX_SHARED_BYTES // 4
    rap.check_launch_plan(s, 1, 256, rap.forward_shared_bytes(s, stage))


@pytest.mark.parametrize("kwargs,match", [
    (dict(channels=12), "multiple of 8"),
    (dict(channels=4), "multiple of 8"),
    (dict(channels=0), "multiple of 8"),
    (dict(s=40), "s \\* r"),
    (dict(s=0), "s \\* r"),
    (dict(r=0), "s \\* r"),
    (dict(s=32, shared=rap.MAX_SHARED_BYTES + 16), "shared memory"),
])
def test_launch_plan_rejects(kwargs, match):
    plan = dict(s=7, r=2, channels=256, shared=None)
    plan.update(kwargs)
    shared = plan.pop("shared")
    if shared is None:
        shared = rap.forward_shared_bytes(plan["s"])
    with pytest.raises(ValueError, match=match):
        rap.check_launch_plan(plan["s"], plan["r"], plan["channels"], shared)


def test_alignment_check_raises():
    buf = torch.zeros(64, dtype=torch.float32)
    rap.check_aligned([buf, buf[4:]], "level")               # 16-byte offsets pass
    with pytest.raises(ValueError, match="16-byte aligned"):
        rap.check_aligned([buf, buf[1:]], "level")
    with pytest.raises(ValueError, match="16-byte aligned"):
        rap.check_aligned([buf[2:]], "level")                # 8-byte aligned is not enough
    rap.check_aligned([torch.zeros(0)], "level")             # no storage, no launch


def test_roi_spans_of_hand_made_weights():
    wy = torch.zeros(3, 2, rap.WIN_Y)
    wx = torch.zeros(3, 2, rap.WIN)
    wy[0, 0, 3], wy[0, 1, 5], wx[0, 0, 0], wx[0, 1, 39] = 1.0, 0.5, 0.25, 0.75
    wy[1, 1, 31], wx[1, 0, 8] = 1.0, 1.0
    wy[2, 0, 4] = 1.0                                          # no x weight at all
    sp = rap.roi_spans(wy, wx).tolist()
    assert sp[0] == [3, 5, 0, 39] and sp[1] == [31, 31, 8, 8]
    assert sp[2][:2] == [4, 4] and sp[2][2] > sp[2][3]


def test_no_first_kernel_is_left():
    """No source of the port and no line of ``chip_smoke.py`` names a ``_v1``
    symbol: the first kernels were removed once every kernel had its span
    design."""
    pkg = pathlib.Path(rap.__file__).resolve().parents[1]
    files = sorted(p for p in pkg.rglob("*") if p.suffix in (".py", ".cu", ".cuh"))
    assert {"roi_align_ml.cu", "roi_align_single.cu", "span_common.cuh",
            "roi_align_ml.py"} <= {p.name for p in files}
    files.append(pkg.parent / "chip_smoke.py")
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert "_v1" not in line, f"{path}:{n}: {line.strip()}"
