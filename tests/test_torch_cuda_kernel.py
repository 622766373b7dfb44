"""The multilevel ROIAlign CUDA kernel vs its plain twin, on the card.

These tests need a CUDA device: they carry the ``cuda`` marker and skip
where there is none (a CUDA kernel has no CPU mode). This file imports no
JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernel.py

Tolerances: f32 (TF32 off) 1e-4 * max(1, max|plain|); bf16 at the AMP
tolerance (rtol 0.05, atol 0.03).
"""
import numpy as np
import pytest
import torch

from u2seg_torch.ops import roi_align_ml as rap

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
