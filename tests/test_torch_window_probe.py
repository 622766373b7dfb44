"""The window-read probe's plain version vs a numpy statement of the JAX
probe's two kernels.

The JAX probe's kernels (``kernel_3d`` and ``kernel_flat`` of
``dev/profile_dma_flat.py``) are closures of its ``main()`` and cannot be
imported, so what they compute is written out here in numpy, step by step as
their bodies do it: per grid step, G windows are copied out of the map
(``[b, oy:oy+wy, ox:ox+wx, :]`` of the 4-D map, or ``[b, oy:oy+wy,
ox*C:(ox+wx)*C]`` of the ``(B, H, W*C)`` view), cast to f32, and
``reshape(-1, 8, 128).sum(0)`` of each is added up. Every step writes the
same output block, so the JAX probe returns the LAST step's sum; the port
returns every step's, and its last row is that result.

Tolerance: f32 sums of up to 640 bf16 values per slot in another order:
rtol 1e-5, atol 1e-4.
"""
import numpy as np
import pytest
import torch

from u2seg_torch.dev import profile_window_read as probe

torch.set_num_threads(1)

SHAPE = (3, 48, 64, 32)      # B, H, W, C
G = 4


def jax_probe_steps(feat: np.ndarray, oy, ox, b, wy, wx, mode, g):
    """(N/g, 8, 128): the value of ``acc`` at the end of every grid step."""
    bsz, h, w, c = feat.shape
    flat = feat.reshape(bsz, h, w * c)
    steps = []
    for step in range(len(oy) // g):
        acc = np.zeros((8, 128), np.float32)
        for j in range(g):
            roi = step * g + j
            if mode == "3d":
                win = feat[b[roi], oy[roi]:oy[roi] + wy, ox[roi]:ox[roi] + wx, :]
            else:
                win = flat[b[roi], oy[roi]:oy[roi] + wy,
                           ox[roi] * c:(ox[roi] + wx) * c]
            assert win.size == wy * wx * c
            acc = acc + win.astype(np.float32).reshape(-1, 8, 128).sum(0)
        steps.append(acc)
    return np.stack(steps)


@pytest.fixture(scope="module")
def feat():
    return probe.make_map(0, "cpu", SHAPE)


@pytest.mark.parametrize("mode,wy,wx", [
    ("3d", 16, 24), ("3d", 32, 40), ("flat", 16, 16), ("flat", 32, 40)])
def test_plain_version_matches_the_jax_probe(feat, mode, wy, wx):
    rng = np.random.RandomState(1)
    oy, ox, b = probe.make_origins(rng, 6 * G, SHAPE, wy, wx, mode, "cpu")
    if mode == "3d":
        assert not (ox % 8).any()
    got = probe.window_sum(feat, oy, ox, b, wy, wx, mode, g=G)
    ref = jax_probe_steps(feat.float().numpy(), oy.numpy(), ox.numpy(),
                          b.numpy(), wy, wx, mode, G)
    assert got.shape == ref.shape == (6, 8, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    assert probe.window_sum.launches == {"3d": 0, "flat": 0}


def test_3d_aligns_the_x_origin_down_and_flat_does_not(feat):
    oy = torch.tensor([3] * G, dtype=torch.int32)
    b = torch.tensor([1] * G, dtype=torch.int32)
    ox = torch.tensor([13] * G, dtype=torch.int32)
    ox8 = torch.tensor([8] * G, dtype=torch.int32)
    at13 = probe.window_sum(feat, oy, ox, b, 16, 16, "3d", g=G)
    at8 = probe.window_sum(feat, oy, ox8, b, 16, 16, "3d", g=G)
    assert torch.equal(at13, at8)
    flat13 = probe.window_sum(feat, oy, ox, b, 16, 16, "flat", g=G)
    assert not torch.equal(flat13, at8)
    assert torch.equal(probe.window_sum(feat, oy, ox8, b, 16, 16, "flat", g=G), at8)


def test_chunked_sum_equals_one_pass_and_bad_shapes_raise(feat):
    rng = np.random.RandomState(2)
    oy, ox, b = probe.make_origins(rng, 8 * G, SHAPE, 16, 16, "flat", "cpu")
    one = probe.window_sum_ref(feat, oy, ox, b, 16, 16, "flat", g=G, chunk_groups=64)
    many = probe.window_sum_ref(feat, oy, ox, b, 16, 16, "flat", g=G, chunk_groups=3)
    assert torch.equal(one, many)
    with pytest.raises(ValueError):
        probe.window_sum(feat, oy[:5], ox[:5], b[:5], 16, 16, "flat", g=G)
    with pytest.raises(ValueError):
        probe.window_sum(feat, oy, ox, b, 16, 16, "diag", g=G)
    with pytest.raises(ValueError):          # 5*7*32 is no multiple of 1024
        probe.window_sum(feat, oy, ox, b, 5, 7, "flat", g=G)


def test_probe_main_refuses_to_run_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main()
