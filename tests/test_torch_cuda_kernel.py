"""The port's CUDA kernels vs their plain versions, on the card: the
multilevel ROIAlign (forward and backward span kernels: main shapes, a ragged
channel width for each dtype pair, levels smaller than the window, what
they reject), the single-level window ROIAlign (the same span design: main
shapes, a ragged width, bins taller than its stage buffer, no ROIs, what it
rejects), the shared memory each library reports, the two window-read
probe kernels (random, edge, clamped and shared-row origins, a banded ring,
what they reject), and the bits of the backward kernel and of the probe
kernels: equal over two runs, and equal again under torch's deterministic
mode.

These tests need a CUDA device: they carry the ``cuda`` marker and skip
where there is none (a CUDA kernel has no CPU mode). This file imports no
JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernel.py

Tolerances: f32 (TF32 off) 1e-4 * max(1, max|plain|); bf16 at the AMP
tolerance (rtol 0.05, atol 0.03). The backward kernel sums each cell's ROIs
in ascending index, in another order than autograd of the twin: its f32
gradients are held to the twin at 1e-4 * max(1, max|plain grad|), its bf16
ones (one rounding of an f32 sum) at rtol 0.05 / atol 0.03 * max(1, max|plain
grad|) / 8, and two of its runs to each other bit for bit. The
single-level kernel accumulates and writes f32 for every input type: 1e-4 *
max(1, max|plain|) for f32 and for bf16 maps alike. The probe kernels sum
bf16 values in f32 in another order than the plain version (running strip
sums, then folds): rtol 1e-5, atol 1e-3 on sums of thousands of values; and
bit for bit against ``window_sum_strips_reference``, which adds in their
order.
"""
import numpy as np
import pytest
import torch

from u2seg_torch.dev import profile_window_read as probe
from u2seg_torch.dev.time_roi_align_backward import pile_boxes
from u2seg_torch.ops import roi_align_ml as rap
from u2seg_torch.ops import roi_align_single as ras

pytestmark = pytest.mark.cuda
STRIDES = (4, 8, 16, 32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, dtype, n=40, c=64, h=56, w=88):
    g = torch.Generator(device=dev).manual_seed(0)
    feats = [torch.randn(2, h >> i, w >> i, c, generator=g, device=dev).to(dtype)
             for i in range(4)]
    rng = np.random.RandomState(0)
    xy = rng.rand(n, 2) * [4 * w, 4 * h]
    wh = np.exp(rng.uniform(np.log(4), np.log(1200), (n, 2)))
    boxes = torch.tensor(np.concatenate([xy, xy + wh], 1), dtype=torch.float32,
                         device=dev)
    bidx = torch.tensor(rng.randint(0, 2, n), dtype=torch.int32, device=dev)
    return feats, boxes, bidx


@pytest.mark.parametrize("s", [7, 14])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_twin(dev, s, dtype):
    feats, boxes, bidx = _inputs(dev, dtype)
    before = rap.multilevel_roi_align_kernel.launches
    got = rap.multilevel_roi_align_kernel(feats, boxes, bidx, s, STRIDES,
                                          out_dtype=dtype)
    assert rap.multilevel_roi_align_kernel.launches == before + 1
    ref = rap.multilevel_roi_align_ref(feats, boxes, bidx, s, STRIDES)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == dtype
    if dtype == torch.float32:
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        assert float((got - ref).abs().max()) <= tol
    else:
        torch.testing.assert_close(got.float(), ref, rtol=0.05, atol=0.03)


def test_kernel_rejects_what_it_does_not_take(dev):
    feats, boxes, bidx = _inputs(dev, torch.float32)
    with pytest.raises(ValueError):
        rap.multilevel_roi_align_kernel(
            [f.transpose(1, 2) for f in feats], boxes, bidx, 7, STRIDES)
    with pytest.raises(ValueError):
        rap.multilevel_roi_align_kernel(
            [f.double() for f in feats], boxes, bidx, 7, STRIDES)
    with pytest.raises(ValueError, match="multiple of 8"):      # 16-byte vectors
        rap.multilevel_roi_align_kernel(
            [f[..., :12].contiguous() for f in feats], boxes, bidx, 7, STRIDES)
    with pytest.raises(ValueError, match="multiple of 8"):
        rap.multilevel_roi_align_train(
            [f[..., :4].contiguous() for f in feats], boxes, bidx, 7, STRIDES)
    with pytest.raises(ValueError, match="s \\* r"):
        rap.multilevel_roi_align_kernel(feats, boxes, bidx, 40, STRIDES)
    # level storage that is 8- but not 16-byte aligned
    off = [torch.empty(f.numel() + 2, device=dev)[2:].view(f.shape).copy_(f)
           for f in feats]
    assert all(f.is_contiguous() and f.data_ptr() % 16 == 8 for f in off)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rap.multilevel_roi_align_kernel(off, boxes, bidx, 7, STRIDES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rap.multilevel_roi_align_train(off, boxes, bidx, 7, STRIDES)
    # a cotangent that is not (R, s, s, C)
    ext, st_ext = rap._append_virtual_level(feats, STRIDES)
    args = rap._prepare_ext(ext, boxes, bidx, 14, 2, st_ext, 224.0, 4, torch.float32)
    with pytest.raises(ValueError, match="cotangent"):
        rap.prepare_backward(torch.zeros(boxes.shape[0], 7, 7, 64, device=dev), args.roi_i,
                             args.roi_f, [tuple(f.shape) for f in args.levels], 14, 2)


@pytest.mark.parametrize("din,dout", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_kernels_at_a_ragged_width(dev, din, dout):
    """C=72: the last chunk of channels is partly empty (64 + 8)."""
    feats, boxes, bidx = _inputs(dev, din, c=72)
    for s in (7, 14):
        got = rap.multilevel_roi_align_kernel(feats, boxes, bidx, s, STRIDES,
                                              out_dtype=dout).float()
        ref = rap.multilevel_roi_align_ref(feats, boxes, bidx, s, STRIDES)
        torch.cuda.synchronize()
        if din == dout == torch.float32:
            assert float((got - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))
        else:
            torch.testing.assert_close(got, ref, rtol=0.05, atol=0.03)
    if dout == torch.bfloat16:
        return
    # the backward at the same width (f32 out is the train pooler's)
    s = 7
    g = torch.randn(boxes.shape[0], s, s, 72, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    fk = [f.clone().requires_grad_() for f in feats]
    fp = [f.clone().requires_grad_() for f in feats]
    got = torch.autograd.grad(
        rap.multilevel_roi_align_train(fk, boxes, bidx, s, STRIDES), fk, g)
    ref = torch.autograd.grad(
        rap.multilevel_roi_align_ref(fp, boxes, bidx, s, STRIDES), fp, g)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        scale = max(1.0, float(b.float().abs().max()))
        err = (a.float() - b.float()).abs()
        if din == torch.float32:
            assert float(err.max()) <= 1e-4 * scale
        else:
            assert bool((err <= 0.03 * scale / 8 + 0.05 * b.float().abs()).all())


@pytest.mark.parametrize("s", [7, 14])
def test_kernels_on_levels_smaller_than_the_window(dev, s):
    """p2..p5 of a 64 x 64 image: 16 x 16 down to 2 x 2, a 1 x 1 virtual level."""
    feats, boxes, bidx = _inputs(dev, torch.float32, n=60, c=16, h=16, w=16)
    boxes = boxes / 6.0
    fk = [f.clone().requires_grad_() for f in feats]
    fp = [f.clone().requires_grad_() for f in feats]
    g = torch.randn(boxes.shape[0], s, s, 16, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    out = rap.multilevel_roi_align_train(fk, boxes, bidx, s, STRIDES)
    ref = rap.multilevel_roi_align_ref(fp, boxes, bidx, s, STRIDES)
    got_g = torch.autograd.grad(out, fk, g)
    ref_g = torch.autograd.grad(ref, fp, g)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))
    for a, b in zip(got_g, ref_g):
        assert float((a - b).abs().max()) <= 1e-4 * max(1.0, float(b.abs().max()))


def test_libraries_and_wrappers_agree_on_shared_memory(dev):
    """What each built library says one block takes is what its wrapper
    plans for."""
    for s in (7, 14):
        assert rap.kernel_shared_bytes(True, s) == rap.backward_shared_bytes(s)
        assert rap.kernel_shared_bytes(False, s) == rap.forward_shared_bytes(
            s, rap.forward_plan(s)[1])
    for s in (1, 7, 14, 32):
        assert ras.kernel_shared_bytes(s) == ras.shared_bytes(s, ras.launch_plan(s)[1])
    for s in (7, 14, 32):
        assert rap.kernel_shared_bytes(True, s) == rap.backward_shared_bytes(s)
        assert rap.kernel_backward_layout(s) == rap.backward_layout(s)


@pytest.mark.parametrize("s", [7, 14])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_matches_autograd_of_twin(dev, s, dtype):
    feats, boxes, bidx = _inputs(dev, dtype)
    g = torch.randn(boxes.shape[0], s, s, feats[0].shape[-1], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    fk = [f.clone().requires_grad_() for f in feats]
    fp = [f.clone().requires_grad_() for f in feats]
    before = (rap.multilevel_roi_align_kernel.launches,
              rap.multilevel_roi_align_backward.launches)
    out = rap.multilevel_roi_align_train(fk, boxes, bidx, s, STRIDES)
    got = torch.autograd.grad(out, fk, g)
    assert (rap.multilevel_roi_align_kernel.launches,
            rap.multilevel_roi_align_backward.launches) == (before[0] + 1, before[1] + 1)
    ref = torch.autograd.grad(
        rap.multilevel_roi_align_ref(fp, boxes, bidx, s, STRIDES), fp, g)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    for a, b in zip(got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        scale = max(1.0, float(b.float().abs().max()))
        err = (a.float() - b.float()).abs()
        if dtype == torch.float32:
            assert float(err.max()) <= 1e-4 * scale
        else:
            assert bool((err <= 0.03 * scale / 8 + 0.05 * b.float().abs()).all())


def test_backward_kernel_through_channels_last_views_and_no_rois(dev):
    feats, boxes, bidx = _inputs(dev, torch.float32)
    leaves = [f.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
              .requires_grad_() for f in feats]
    out = rap.multilevel_roi_align_train(
        [t.permute(0, 2, 3, 1) for t in leaves], boxes, bidx, 7, STRIDES)
    out.sum().backward()
    fp = [f.clone().requires_grad_() for f in feats]
    rap.multilevel_roi_align_ref(fp, boxes, bidx, 7, STRIDES).sum().backward()
    for leaf, p in zip(leaves, fp):
        assert leaf.grad.shape == leaf.shape
        assert float((leaf.grad.permute(0, 2, 3, 1) - p.grad).abs().max()) <= 1e-4 * max(
            1.0, float(p.grad.abs().max()))
    empty = rap.multilevel_roi_align_train(
        [f.clone().requires_grad_() for f in feats], boxes[:0], bidx[:0], 7, STRIDES)
    assert empty.shape == (0, 7, 7, feats[0].shape[-1])


def test_backward_kernel_repeats_bit_for_bit_also_in_deterministic_mode(dev):
    """At the train step's shapes (b=2 at 800x1344, C=256, bf16 levels, f32
    cotangent, R=1024 at s=7) two backward runs on the same inputs give the
    same bits (each gradient cell sums its ROIs in ascending index), and
    under torch's deterministic mode the backward runs and gives them again."""
    gen = torch.Generator(device=dev).manual_seed(5)
    feats = [torch.randn(2, 800 // st, 1344 // st, 256, generator=gen, device=dev)
             .to(torch.bfloat16).requires_grad_() for st in STRIDES]
    rng = np.random.RandomState(5)
    xy = rng.rand(1024, 2) * [1344, 800]
    wh = np.exp(rng.uniform(np.log(8), np.log(800), (1024, 2)))
    boxes = torch.tensor(np.concatenate([xy, xy + wh], 1), dtype=torch.float32, device=dev)
    bidx = torch.tensor(rng.randint(0, 2, 1024), dtype=torch.int32, device=dev)
    g = torch.randn(1024, 7, 7, 256, generator=gen, device=dev)
    out = rap.multilevel_roi_align_train(feats, boxes, bidx, 7, STRIDES)
    runs = [torch.autograd.grad(out, feats, g, retain_graph=True) for _ in range(2)]
    before = torch.are_deterministic_algorithms_enabled()
    try:
        torch.use_deterministic_algorithms(True)
        runs.append(torch.autograd.grad(out, feats, g))
    finally:
        torch.use_deterministic_algorithms(before)
    torch.cuda.synchronize()
    for a, b, c in zip(*runs):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert float(sum(t.float().abs().sum() for t in runs[0])) > 0


def _pile(dev, s, dtype=torch.float32, n=200):
    """``pile_boxes``: ~200 large ROIs over one region of image 0 (b=2 at
    800x1344, C=64), whose p5 and virtual-level tile lists run past 4
    segments."""
    gen = torch.Generator(device=dev).manual_seed(6)
    feats = [torch.randn(2, 800 // st, 1344 // st, 64, generator=gen, device=dev).to(dtype)
             for st in STRIDES]
    boxes = pile_boxes(np.random.RandomState(6), n).to(dev)
    bidx = torch.zeros(n, dtype=torch.int32, device=dev)
    g = torch.randn(n, s, s, 64, generator=gen, device=dev)
    return feats, boxes, bidx, g


def _pile_args(dev, s, dtype=torch.float32):
    feats, boxes, bidx, g = _pile(dev, s, dtype)
    ext, st_ext = rap._append_virtual_level(feats, STRIDES)
    fa = rap._prepare_ext(ext, boxes, bidx, s, 2, st_ext, 224.0, 4, torch.float32)
    shapes = [tuple(f.shape) for f in ext]
    return feats, boxes, bidx, g, fa, shapes


@pytest.mark.parametrize("s", [7, 14])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_on_a_pile_of_long_lists(dev, s, dtype):
    """Against autograd of the twin at the usual tolerances, where the p5
    and virtual-level lists run longer than 4 segments (checked on the
    kernel's own counts)."""
    feats, boxes, bidx, g, fa, shapes = _pile_args(dev, s, dtype)
    ba = rap.prepare_backward(g, fa.roi_i, fa.roi_f, shapes, s, 2)
    rap.multilevel_roi_align_backward(ba)
    firsts = rap.backward_tiles(shapes)[1]
    for lvl in (3, 4):
        longest = int(ba.tile_count[firsts[lvl]:firsts[lvl + 1]].max())
        assert longest > 4 * rap.SEGMENT, (lvl, longest)
    fk = [f.clone().requires_grad_() for f in feats]
    fp = [f.clone().requires_grad_() for f in feats]
    got = torch.autograd.grad(rap.multilevel_roi_align_train(fk, boxes, bidx, s, STRIDES),
                              fk, g)
    ref = torch.autograd.grad(rap.multilevel_roi_align_ref(fp, boxes, bidx, s, STRIDES),
                              fp, g)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        scale = max(1.0, float(b.float().abs().max()))
        err = (a.float() - b.float()).abs()
        if dtype == torch.float32:
            assert float(err.max()) <= 1e-4 * scale
        else:
            assert bool((err <= 0.03 * scale / 8 + 0.05 * b.float().abs()).all())


@pytest.mark.parametrize("s", [7, 14])
def test_backward_kernel_follows_its_plan_and_reference_on_a_pile(dev, s):
    """The kernel's plan is ``segment_plan`` of its own list starts; every
    tile's list holds ascending ROIs, all of them in the plain routing's
    list; the kernel equals ``ordered_backward_reference`` on the kernel's
    lists (the same association of ROI terms) to 1e-5 * max|grad|: each
    ROI's term differs in its last bits (an einsum there, FMA chains over
    tables with FMA-contracted coordinates here), and over lists of ~100
    ROIs that walks past 1e-6 * max|grad|; a tile with no ROI gets zeros (the
    levels are filled with NaN first); the partial slots stay within what
    the wrapper allocated."""
    _, _, _, g, fa, shapes = _pile_args(dev, s)
    ba = rap.prepare_backward(g, fa.roi_i, fa.roi_f, shapes, s, 2)
    for t in ba.grads:
        t.fill_(float("nan"))
    got = rap.multilevel_roi_align_backward(ba)
    starts, rois, plan = rap.backward_routing(fa.roi_i, fa.roi_f, shapes, s, 2)
    own = (ba.tile_start, ba.lists[:int(ba.tile_start[-1])] >> rap.PAIR_BITS)
    ref = rap.ordered_backward_reference(g, fa.roi_i, fa.roi_f, shapes, s, 2, routing=own)
    torch.cuda.synchronize()
    n_items, n_folds, _ = ba.counts.tolist()
    plain = rap.segment_plan(ba.tile_start.cpu())
    assert torch.equal(ba.items[:n_items].long().cpu(), plain.items)
    assert torch.equal(ba.folds[:n_folds, :3].long().cpu(), plain.folds)
    assert n_folds > 0 and int(ba.items[:n_items, 3].max()) < ba.partials.shape[0]
    kstart, pstart = ba.tile_start.tolist(), starts.tolist()
    entries, rois = (ba.lists >> rap.PAIR_BITS).tolist(), rois.tolist()
    for t in range(len(kstart) - 1):
        listed = entries[kstart[t]:kstart[t + 1]]
        assert listed == sorted(set(listed)) and set(listed) <= set(rois[pstart[t]:pstart[t + 1]])
    firsts = rap.backward_tiles(shapes)[1]
    empty = 0
    for lvl, (a, b) in enumerate(zip(got, ref)):
        assert not bool(torch.isnan(a).any())
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
        counts = ba.tile_count[firsts[lvl]:firsts[lvl + 1]]
        cut = a.shape[1] // 8 * 8, a.shape[2] // 8 * 8       # whole tiles only
        tiles = a[:, :cut[0], :cut[1]].reshape(a.shape[0], cut[0] // 8, 8, cut[1] // 8, 8, -1)
        per_tile = tiles.abs().amax(dim=(2, 4, 5)).flatten()
        rows, cols = (a.shape[1] + 7) // 8, (a.shape[2] + 7) // 8
        whole = counts.reshape(a.shape[0], rows, cols)[:, :cut[0] // 8, :cut[1] // 8].flatten()
        assert bool((per_tile[whole == 0] == 0).all())
        empty += int((whole == 0).sum())
    assert empty > 0


def test_backward_kernel_repeats_bit_for_bit_on_a_pile(dev):
    """Two runs and a run under torch's deterministic mode give the same
    bits where lists are cut into segments and folded."""
    for s in (7, 14):
        _, _, _, g, fa, shapes = _pile_args(dev, s)
        runs = [[t.clone() for t in rap.multilevel_roi_align_backward(
            rap.prepare_backward(g, fa.roi_i, fa.roi_f, shapes, s, 2))] for _ in range(2)]
        before = torch.are_deterministic_algorithms_enabled()
        try:
            torch.use_deterministic_algorithms(True)
            runs.append(rap.multilevel_roi_align_backward(
                rap.prepare_backward(g, fa.roi_i, fa.roi_f, shapes, s, 2)))
        finally:
            torch.use_deterministic_algorithms(before)
        torch.cuda.synchronize()
        for a, b, c in zip(*runs):
            assert torch.equal(a, b) and torch.equal(a, c)


def test_backward_kernel_at_s32(dev):
    """s=32: a slot holds one row of bins, so a ROI's bins come in pieces."""
    feats, boxes, bidx = _inputs(dev, torch.float32)
    g = torch.randn(boxes.shape[0], 32, 32, 64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    fk = [f.clone().requires_grad_() for f in feats]
    fp = [f.clone().requires_grad_() for f in feats]
    got = torch.autograd.grad(rap.multilevel_roi_align_train(fk, boxes, bidx, 32, STRIDES),
                              fk, g)
    ref = torch.autograd.grad(rap.multilevel_roi_align_ref(fp, boxes, bidx, 32, STRIDES),
                              fp, g)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= 1e-4 * max(1.0, float(b.abs().max()))


# ---------------------------------------------------------------------------
# the single-level window ROIAlign
# ---------------------------------------------------------------------------

def _single_inputs(dev, dtype, n=60, c=64, h=72, w=104):
    g = torch.Generator(device=dev).manual_seed(0)
    feat = torch.randn(2, h, w, c, generator=g, device=dev).to(dtype)
    rng = np.random.RandomState(0)
    xy = rng.rand(n, 2) * [8 * w, 8 * h]
    wh = np.exp(rng.uniform(np.log(8), np.log(400), (n, 2)))   # up to 50 cells
    boxes = np.concatenate([xy, xy + wh], 1)
    boxes[:3] = [[0, 0, 0, 0], [40, 40, 40, 40], [8, 16, 8 * w - 8, 8 * h - 8]]
    boxes = torch.tensor(boxes, dtype=torch.float32, device=dev)
    bidx = torch.tensor(rng.randint(0, 2, n), dtype=torch.int32, device=dev)
    return feat, boxes, bidx


@pytest.mark.parametrize("s,r", [(7, 2), (14, 2), (7, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_level_kernel_matches_plain_version(dev, s, r, dtype):
    feat, boxes, bidx = _single_inputs(dev, dtype)
    before = ras.roi_align_single.launches
    got = ras.roi_align_single(feat, boxes, bidx, s, 0.125, r)
    assert ras.roi_align_single.launches == before + 1
    ref = ras.roi_align_single_ref(feat, boxes, bidx, s, 0.125, r)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert float((got - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))
    assert ras.roi_align_single(feat, boxes[:0], bidx[:0], s, 0.125, r).shape == (
        0, s, s, feat.shape[-1])
    assert ras.roi_align_single.launches == before + 1     # R = 0 launches nothing


def test_single_level_kernel_raises_on_what_it_does_not_take(dev):
    feat, boxes, bidx = _single_inputs(dev, torch.float32)
    with pytest.raises(ValueError):         # not contiguous
        ras.roi_align_single(feat.transpose(1, 2), boxes, bidx, 7, 0.125)
    with pytest.raises(ValueError):         # unsupported dtype
        ras.roi_align_single(feat.double(), boxes, bidx, 7, 0.125)
    with pytest.raises(ValueError, match="multiple of 8"):      # odd channel count
        ras.roi_align_single(feat[..., :63].contiguous(), boxes, bidx, 7, 0.125)
    with pytest.raises(ValueError, match="multiple of 8"):      # even, not 16-byte vectors
        ras.roi_align_single(feat[..., :12].contiguous(), boxes, bidx, 7, 0.125)
    with pytest.raises(ValueError, match="smaller than"):       # map smaller than the window
        ras.roi_align_single(feat[:, :32].contiguous(), boxes, bidx, 7, 0.125)
    with pytest.raises(ValueError, match="s \\* r"):           # too many samples per axis
        ras.roi_align_single(feat, boxes, bidx, 40, 0.125, 2)
    off = torch.empty(feat.numel() + 2, device=dev)[2:].view(feat.shape).copy_(feat)
    assert off.is_contiguous() and off.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte aligned"):
        ras.roi_align_single(off, boxes, bidx, 7, 0.125)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_level_kernel_at_a_ragged_width(dev, dtype):
    """C=72: the last chunk of 64 channels holds 8."""
    feat, boxes, bidx = _single_inputs(dev, dtype, c=72)
    for s in (7, 14):
        got = ras.roi_align_single(feat, boxes, bidx, s, 0.125)
        ref = ras.roi_align_single_ref(feat, boxes, bidx, s, 0.125)
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (boxes.shape[0], s, s, 72)
        assert float((got - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_level_kernel_on_bins_taller_than_its_stage_buffer(dev, dtype):
    """Boxes as large as the window at s=1..3: a bin spans 8-22 map rows under
    a span of up to 40 columns, more than the stage buffer holds, so those
    bins read global memory."""
    feat, _, _ = _single_inputs(dev, dtype)
    boxes = torch.tensor([[0.0, 0.0, 320.0, 320.0], [50.0, 30.0, 370.0, 330.0],
                          [400.0, 200.0, 720.0, 520.0], [8.0, 8.0, 40.0, 300.0]],
                         device=dev)
    bidx = torch.tensor([0, 1, 1, 0], dtype=torch.int32, device=dev)
    for s in (1, 2, 3):
        wy, wx, _ = ras.pooled_axis_weights(boxes, *feat.shape[1:3], s, 2, 0.125)
        cells = torch.arange(ras.WIN, device=dev)
        lo = lambda m: torch.where(m, cells, ras.WIN).amin(-1)
        hi = lambda m: torch.where(m, cells, -1).amax(-1)
        bin_rows = (hi(wy != 0) - lo(wy != 0) + 1).amax(-1)        # tallest bin per ROI
        span_x = hi((wx != 0).any(1)) - lo((wx != 0).any(1)) + 1
        cap = ras.launch_plan(s)[1] // (ras.CHUNK * feat.element_size()) // span_x
        assert bool((bin_rows > cap).any())
        got = ras.roi_align_single(feat, boxes, bidx, s, 0.125)
        ref = ras.roi_align_single_ref(feat, boxes, bidx, s, 0.125)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))


def test_single_level_kernel_with_no_rois(dev):
    feat, boxes, bidx = _single_inputs(dev, torch.bfloat16)
    before = ras.roi_align_single.launches
    for s in (7, 14):
        out = ras.roi_align_single(feat, boxes[:0], bidx[:0], s, 0.125)
        assert out.shape == (0, s, s, feat.shape[-1]) and out.dtype == torch.float32
    assert ras.roi_align_single.launches == before


# ---------------------------------------------------------------------------
# the window-read probe
# ---------------------------------------------------------------------------

PROBE_MAP = (3, 64, 96, 256)
# the JAX probe's shapes, and a ring too tall for the whole width of a wider
# map: two column bands with a halo
PROBE_SHAPES = [("3d", 32, 40, PROBE_MAP), ("flat", 32, 40, PROBE_MAP),
                ("flat", 32, 32, PROBE_MAP), ("flat", 16, 16, PROBE_MAP),
                ("3d", 16, 24, PROBE_MAP), ("3d", 56, 40, (2, 64, 400, 256))]


@pytest.mark.parametrize("mode,wy,wx,shape", PROBE_SHAPES)
def test_probe_kernels_match_plain_version(dev, mode, wy, wx, shape):
    feat = probe.make_map(0, dev, shape)
    cases = probe.check_cases(np.random.RandomState(1), shape, wy, wx, mode, dev)
    for name, (oy, ox, b) in cases.items():
        before = probe.window_sum.launches[mode]
        got, row_start, order = probe.launch(feat, oy, ox, b, wy, wx, mode)
        assert probe.window_sum.launches[mode] == before + 1
        ref = probe.window_sum_ref(feat, oy, ox, b, wy, wx, mode)
        lists = probe.window_routing(oy, b, shape[0], shape[1], wy)
        torch.cuda.synchronize()
        assert torch.equal(row_start, lists[0]) and torch.equal(order, lists[1]), name
        assert got.shape == ref.shape == (oy.shape[0] // probe.GROUP, 8, 128), name
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-3, msg=name)


@pytest.mark.parametrize("mode,wy,wx,shape", PROBE_SHAPES)
def test_probe_kernels_repeat_bit_for_bit(dev, mode, wy, wx, shape):
    """Fixed sum orders: two calls give the same bits, so does a call under
    torch's deterministic mode (which fills the partial table with NaN
    first), and so does the algorithm's plain statement, which makes the
    same f32 adds in the same order."""
    feat = probe.make_map(0, dev, shape)
    oy, ox, b = probe.check_cases(np.random.RandomState(2), shape, wy, wx, mode,
                                  dev)["edge"]
    runs = [probe.window_sum(feat, oy, ox, b, wy, wx, mode) for _ in range(2)]
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs.append(probe.window_sum(feat, oy, ox, b, wy, wx, mode))
    finally:
        torch.use_deterministic_algorithms(before)
    runs.append(probe.window_sum_strips_reference(feat, oy, ox, b, wy, wx, mode))
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert torch.equal(runs[0], other)


def test_probe_kernels_raise_on_what_they_do_not_take(dev):
    shape = (2, 64, 96, 256)
    feat = probe.make_map(0, dev, shape)
    oy, ox, b = probe.make_origins(np.random.RandomState(1), 16, shape, 16, 16,
                                   "flat", dev)
    with pytest.raises(ValueError):         # f32 map
        probe.window_sum(feat.float(), oy, ox, b, 16, 16, "flat")
    with pytest.raises(ValueError):         # int64 origins
        probe.window_sum(feat, oy.long(), ox, b, 16, 16, "flat")
    with pytest.raises(ValueError):         # N not a multiple of the group
        probe.window_sum(feat, oy[:5], ox[:5], b[:5], 16, 16, "3d")
    with pytest.raises(ValueError):         # window larger than the map
        probe.window_sum(feat, oy, ox, b, 80, 16, "3d")
    with pytest.raises(ValueError):         # wx*C = 1536: slots depend on the row
        probe.window_sum(feat, oy, ox, b, 16, 6, "flat")
    before = dict(probe.window_sum.launches)
    out = probe.window_sum(feat, oy[:0], ox[:0], b[:0], 16, 16, "flat")
    assert out.shape == (0, 8, 128) and probe.window_sum.launches == before
