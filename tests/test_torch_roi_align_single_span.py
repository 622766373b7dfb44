"""What the span design of the single-level window ROIAlign kernel
(``u2seg_torch/csrc/roi_align_single.cu``) rests on, checked on the CPU with
numpy-seeded inputs; and that an edit of a shared header rebuilds the
kernels. (The dense-weight identity, ``Wy @ window @ Wx^T`` against the plain
version and the JAX ``roi_align_pallas``, is held in
``tests/test_torch_roi_align_single.py``.)

(a) The span invariant. Every cell of non-zero weight lies inside the ROI's
    40 x 40 window and inside the map, on random and edge boxes (over-long,
    past the corner, the origin clipped at the far corner) and on maps from
    the window's own size up, so the kernel reads a span without a bounds
    test.
(b) The launch plan: at least 2 s threads, a stage buffer that holds a span
    row of 40 cells of 64 f32 channels, shared memory within 227 KB.
(c) The contract: C a multiple of 8 and 16-byte aligned storage, or the
    wrapper raises.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from u2seg_torch import _cuda
from u2seg_torch.ops import roi_align_ml as rap
from u2seg_torch.ops import roi_align_single as ras

torch.set_num_threads(1)

WIN = ras.WIN


def random_boxes(rng, n, h, w, stride):
    """Boxes of 1-60 cells at ``stride`` px per cell, some past the map's
    edges, a tenth of zero size."""
    bw = np.exp(rng.uniform(0, np.log(60), n)) * stride
    bh = np.exp(rng.uniform(0, np.log(60), n)) * stride
    x0 = rng.uniform(-0.2, 1.1, n) * w * stride
    y0 = rng.uniform(-0.2, 1.1, n) * h * stride
    b = np.stack([x0, y0, x0 + bw, y0 + bh], 1)
    b[: n // 10, 2:] = b[: n // 10, :2]                   # zero size
    return b.astype(np.float32)


@pytest.mark.parametrize("hw", [(40, 40), (64, 64), (100, 152)],
                         ids=["window", "square", "p3"])
@pytest.mark.parametrize("s", [2, 7, 14])
def test_every_nonzero_weight_lies_in_the_window_and_the_map(hw, s):
    h, w = hw
    rng = np.random.RandomState(h + s)
    stride = 8
    edge = np.array([
        [w * stride - 100.0, h * stride - 90.0, w * stride + 60.0, h * stride + 40.0],
        [w * stride - 200.0, h * stride - 200.0, w * stride - 8.0, h * stride - 8.0],
        [0.0, 0.0, 56.0 * stride, 50.0 * stride],         # over-long on both axes
        [-30.0, -20.0, 10.0, 12.0],                       # before the map's origin
    ], np.float32)
    boxes = torch.from_numpy(np.concatenate([edge, random_boxes(rng, 400, h, w, stride)]))
    wy, wx, origin = ras.pooled_axis_weights(boxes, h, w, s, 2, 1.0 / stride)
    assert wy.shape == wx.shape == (len(boxes), s, WIN)
    assert float(wy.min()) >= 0.0 and float(wx.min()) >= 0.0
    # each bin's weights sum to at most 1 (less where samples fell off)
    assert float(wy.sum(-1).max()) <= 1.0 + 1e-5 and float(wx.sum(-1).max()) <= 1.0 + 1e-5
    oy, ox = origin[:, 0].long(), origin[:, 1].long()
    assert bool((oy >= 0).all()) and bool((ox >= 0).all()) and bool((ox % 8 == 0).all())
    assert bool((oy <= h - WIN).all()) and bool((ox <= w - WIN).all())
    cells = torch.arange(WIN)
    for wgt, org, size in ((wy, oy, h), (wx, ox, w)):
        hit = (wgt != 0).any(1)                                    # (R, WIN)
        where = org[:, None] + cells                               # map cell of each
        assert bool(((where < size) | ~hit).all()) and bool(((where >= 0) | ~hit).all())
    sp = rap.roi_spans(wy, wx)
    has = (sp[:, 1] >= sp[:, 0]) & (sp[:, 3] >= sp[:, 2])
    assert int(has.sum()) > len(boxes) // 2
    assert int((sp[:, 1] - sp[:, 0] + 1)[has].max()) <= WIN
    # the far-corner clip engaged, and the box past the map keeps some weight
    assert int(oy[1]) == h - WIN and bool(has[0])
    # the over-long box lost weight past the window on both axes
    assert float(wy[2].sum(-1).min()) < 1.0 and float(wx[2].sum(-1).min()) < 1.0


@pytest.mark.parametrize("s", [1, 2, 7, 8, 9, 14, 28, 64])
def test_launch_plan_is_one_the_source_takes(s):
    threads, stage = ras.launch_plan(s)
    assert threads % 32 == 0 and max(32, 2 * s) <= threads <= 256
    assert stage % 16 == 0 and stage >= WIN * ras.CHUNK * 4    # a span row of f32 cells
    assert ras.shared_bytes(s, stage) <= 232448                # 227 KB
    ras.check_launch_plan(s, 1, 256, ras.shared_bytes(s, stage))
    assert ras.shared_bytes(7, 24576) == 24576 + 4 * (7 * 80 + 28 + 160)
    assert ras.launch_plan(7) == ras.launch_plan(14) == (128, 24576)


@pytest.mark.parametrize("shape,dtype,offset,match", [
    ((1, 40, 40, 12), torch.float32, 0, "multiple of 8"),
    ((1, 40, 40, 4), torch.bfloat16, 0, "multiple of 8"),
    ((1, 40, 40, 64), torch.float32, 2, "16-byte aligned"),      # 8-byte aligned
    ((1, 40, 40, 64), torch.bfloat16, 4, "16-byte aligned"),     # 8-byte aligned
    ((1, 39, 64, 64), torch.float32, 0, "smaller than"),
    ((1, 40, 40, 64), torch.float64, 0, "unsupported dtype"),
])
def test_contract_rejects(shape, dtype, offset, match):
    n = int(np.prod(shape))
    feat = torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)
    with pytest.raises(ValueError, match=match):
        ras.check_contract(feat, 7, 2)


def test_contract_takes_a_ragged_width_and_rejects_the_rest():
    for c, dtype in ((72, torch.float32), (72, torch.bfloat16), (8, torch.float32)):
        for s in (7, 14):
            ras.check_contract(torch.zeros(2, 40, 48, c, dtype=dtype), s, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ras.check_contract(torch.zeros(1, 40, 40, 64).transpose(1, 2), 7, 2)
    with pytest.raises(ValueError, match="s \\* r"):
        ras.check_contract(torch.zeros(1, 40, 40, 64), 40, 2)
    # a view at a 16-byte offset is aligned and taken
    ras.check_contract(torch.zeros(4 + 40 * 40 * 64)[4:].view(1, 40, 40, 64), 7, 2)


def test_a_header_edit_changes_every_library_path(tmp_path, monkeypatch):
    """Both span sources include ``span_common.cuh``: an edit of any header
    must give new library names, or a stale build would be loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC_DIR, csrc)
    monkeypatch.setattr(_cuda, "CSRC_DIR", str(csrc))
    names = ["roi_align_ml", "roi_align_single", "window_probe"]
    before = {n: _cuda.library_path(n) for n in names}
    assert len(set(before.values())) == 3
    assert all(os.path.dirname(p) == _cuda.BUILD_DIR for p in before.values())
    assert _cuda.library_path("roi_align_ml") == before["roi_align_ml"]   # stable
    header = csrc / "span_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _cuda.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    (csrc / "extra.cuh").write_text("// a new header\n")       # a new header counts too
    assert _cuda.library_path("roi_align_single") != after["roi_align_single"]
    # a source elsewhere (a development build) is hashed with the headers too
    other = tmp_path / "variant.cu"
    other.write_text((csrc / "roi_align_single.cu").read_text())
    path = _cuda.library_path(str(other))
    assert os.path.basename(path).startswith("libvariant-")
    header.write_bytes(header.read_bytes() + b"// again\n")
    assert _cuda.library_path(str(other)) != path
