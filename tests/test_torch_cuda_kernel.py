"""The port's CUDA kernels vs their plain versions, on the card: the
multilevel ROIAlign (forward and backward span kernels: main shapes, a ragged
channel width for each dtype pair, levels smaller than the window, what
they reject, and the first kernels they are timed against), the single-level
window ROIAlign and the two window-read probe kernels.

These tests need a CUDA device: they carry the ``cuda`` marker and skip
where there is none (a CUDA kernel has no CPU mode). This file imports no
JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernel.py

Tolerances: f32 (TF32 off) 1e-4 * max(1, max|plain|); bf16 at the AMP
tolerance (rtol 0.05, atol 0.03). The backward kernel adds with atomics,
whose order changes from run to run: its f32 gradients are held to autograd of
the twin at 1e-4 * max(1, max|plain grad|), its bf16 ones (one rounding of an
f32 sum) at rtol 0.05 / atol 0.03 * max(1, max|plain grad|) / 8. The
single-level kernel accumulates and writes f32 for every input type: 1e-4 *
max(1, max|plain|) for f32 and for bf16 maps alike. The probe kernels sum
bf16 values in f32 in another order than the plain version: rtol 1e-5, atol
1e-3 on sums of thousands of values.
"""
import numpy as np
import pytest
import torch

from u2seg_torch.dev import profile_window_read as probe
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
    # an output size whose cotangent tile exceeds a block's shared memory
    ext, st_ext = rap._append_virtual_level(feats, STRIDES)
    args = rap._prepare_ext(ext, boxes, bidx, 32, 2, st_ext, 224.0, 4, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        rap.multilevel_roi_align_backward(rap.prepare_backward(
            torch.zeros(boxes.shape[0], 32, 32, 64, device=dev), args.roi_i, args.roi_f,
            [tuple(f.shape) for f in args.levels], 32, 2))


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


def test_first_kernels_agree_with_the_span_kernels(dev):
    """The yardstick kernels (v1) still compute the same function."""
    feats, boxes, bidx = _inputs(dev, torch.float32)
    before = rap.multilevel_roi_align_kernel.launches
    new = rap.launch(rap.prepare_launch(feats, boxes, bidx, 7, 2, STRIDES, 224.0, 4,
                                        torch.float32))
    old = rap.launch_v1(rap.prepare_launch(feats, boxes, bidx, 7, 2, STRIDES, 224.0, 4,
                                           torch.float32))
    torch.cuda.synchronize()
    assert rap.multilevel_roi_align_kernel.launches == before + 1   # v1 counts nothing
    assert float((new - old).abs().max()) <= 1e-4 * max(1.0, float(new.abs().max()))
    # and the backward one, at the tolerance its plain version is held to
    g = torch.randn(boxes.shape[0], 7, 7, feats[0].shape[-1], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    ext, st_ext = rap._append_virtual_level(feats, STRIDES)
    fa = rap._prepare_ext(ext, boxes, bidx, 7, 2, st_ext, 224.0, 4, torch.float32)
    shapes = [tuple(f.shape) for f in ext]
    before = rap.multilevel_roi_align_backward.launches
    new_g = rap.multilevel_roi_align_backward(
        rap.prepare_backward(g, fa.roi_i, fa.roi_f, shapes, 7, 2))
    old_g = rap.multilevel_roi_align_backward_v1(
        rap.prepare_backward(g, fa.roi_i, fa.roi_f, shapes, 7, 2))
    torch.cuda.synchronize()
    assert rap.multilevel_roi_align_backward.launches == before + 1
    for a, b in zip(new_g, old_g):
        assert float((a - b).abs().max()) <= 1e-4 * max(1.0, float(a.abs().max()))
    # the library and the wrapper agree on a block's shared memory
    for s in (7, 14):
        assert rap.kernel_shared_bytes(True, s) == rap.backward_shared_bytes(s)
        assert rap.kernel_shared_bytes(False, s) == rap.forward_shared_bytes(
            s, rap.forward_plan(s)[1])


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
    with pytest.raises(ValueError):         # odd channel count
        ras.roi_align_single(feat[..., :63].contiguous(), boxes, bidx, 7, 0.125)
    with pytest.raises(ValueError):         # map smaller than the window
        ras.roi_align_single(feat[:, :32].contiguous(), boxes, bidx, 7, 0.125)
    with pytest.raises(ValueError):         # too many samples per axis
        ras.roi_align_single(feat, boxes, bidx, 40, 0.125, 2)


# ---------------------------------------------------------------------------
# the window-read probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,wy,wx", [
    ("3d", 32, 40), ("flat", 32, 40), ("flat", 32, 32), ("flat", 16, 16),
    ("3d", 16, 24)])
def test_probe_kernels_match_plain_version(dev, mode, wy, wx):
    shape = (3, 64, 96, 256)
    feat = probe.make_map(0, dev, shape)
    oy, ox, b = probe.make_origins(np.random.RandomState(1), 64, shape, wy, wx,
                                   mode, dev)
    if mode == "3d":
        ox = ox + 3          # the kernel aligns down itself
    before = probe.window_sum.launches[mode]
    got = probe.window_sum(feat, oy, ox, b, wy, wx, mode)
    assert probe.window_sum.launches[mode] == before + 1
    ref = probe.window_sum_ref(feat, oy, ox, b, wy, wx, mode)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (8, 8, 128)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-3)


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
