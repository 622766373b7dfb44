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

The kernels' algorithm (``window_sum_strips_reference``: routing lists,
running column-strip sums, the fold by column, the group sums) is held to
the same statement on the JAX probe's five window shapes with C=256, and on
edge, clamped, unaligned-3d and shared-row origins (the JAX statement then
takes the origins after the port's clamp and alignment, as the kernels read
them).

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


KSHAPE = (3, 48, 64, 256)    # B, H, W, C: C as in the JAX probe, wx*C % 1024 == 0
JAX_SHAPES = [(mode, wy, wx) for _, mode, wy, wx in probe.SHAPES]


@pytest.fixture(scope="module")
def wide():
    return probe.make_map(3, "cpu", KSHAPE)


def _as_read(shape, oy, ox, b, wy, wx, mode):
    """The origins the kernels read: clamped into the map, 3d x aligned down."""
    bsz, h, w, _ = shape
    ox = np.clip(ox.numpy(), 0, w - wx)
    return (np.clip(oy.numpy(), 0, h - wy), ox // 8 * 8 if mode == "3d" else ox,
            np.clip(b.numpy(), 0, bsz - 1))


@pytest.mark.parametrize("mode,wy,wx", JAX_SHAPES)
def test_strips_algorithm_matches_the_jax_probe(wide, mode, wy, wx):
    oy, ox, b = probe.make_origins(np.random.RandomState(4), 6 * G, KSHAPE, wy, wx,
                                   mode, "cpu")
    got = probe.window_sum_strips_reference(wide, oy, ox, b, wy, wx, mode, g=G)
    ref = jax_probe_steps(wide.float().numpy(), oy.numpy(), ox.numpy(), b.numpy(),
                          wy, wx, mode, G)
    assert got.shape == ref.shape == (6, 8, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", ["random", "edge", "shared"])
@pytest.mark.parametrize("mode,wy,wx", JAX_SHAPES)
def test_strips_algorithm_on_unaligned_edge_clamped_and_shared_origins(
        wide, mode, wy, wx, case):
    """``random``: 3d origins off the 8-grid; ``edge``: last row and column,
    origins and images past the map; ``shared``: every window on one (image,
    origin row)."""
    oy, ox, b = probe.check_cases(np.random.RandomState(5), KSHAPE, wy, wx, mode,
                                  "cpu", shared=64)[case]
    if case == "random":
        oy, ox, b = oy[:16 * G], ox[:16 * G], b[:16 * G]
    got = probe.window_sum_strips_reference(wide, oy, ox, b, wy, wx, mode, g=G)
    ref = jax_probe_steps(wide.float().numpy(),
                          *_as_read(KSHAPE, oy, ox, b, wy, wx, mode), wy, wx, mode, G)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    plain = probe.window_sum(wide, oy, ox, b, wy, wx, mode, g=G)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_routing_lists_windows_by_image_and_origin_row_in_index_order():
    rng = np.random.RandomState(6)
    n, wy = 200, 16
    bsz, h = KSHAPE[:2]
    oy = torch.from_numpy(rng.randint(-3, h + 3, n).astype(np.int32))
    b = torch.from_numpy(rng.randint(-1, bsz + 1, n).astype(np.int32))
    row_start, order = probe.window_routing(oy, b, bsz, h, wy)
    assert row_start.dtype == order.dtype == torch.int32
    assert row_start.shape == (bsz * h + 1,) and sorted(order.tolist()) == list(range(n))
    lists = (b.clamp(0, bsz - 1) * h + oy.clamp(0, h - wy)).tolist()
    for k in range(bsz * h):
        members = order[row_start[k]:row_start[k + 1]].tolist()
        assert members == [i for i in range(n) if lists[i] == k]


def test_kernel_contract_needs_row_free_slots_and_a_ring_that_fits(wide):
    """The kernels' shape check (no CUDA tensor exists here to reach it
    through ``window_sum``)."""
    for mode, wy, wx in JAX_SHAPES:
        probe.check_kernel_shapes(KSHAPE, wy, wx)
    with pytest.raises(ValueError, match="wx\\*C"):     # 6 * 256 = 1536
        probe.check_kernel_shapes(KSHAPE, 16, 6)
    with pytest.raises(ValueError, match="wx\\*C"):
        probe.window_sum_strips_reference(
            wide, *probe.make_origins(np.random.RandomState(0), G, KSHAPE, 16, 6,
                                      "flat", "cpu"), 16, 6, "flat", g=G)
    with pytest.raises(ValueError, match="shared memory"):
        probe.check_kernel_shapes((1, 1500, 64, 256), 1400, 40)
    with pytest.raises(ValueError, match="rows"):
        probe.check_kernel_shapes((1, 2000, 64, 256), 16, 16)
    # the plain version keeps its wider contract: wy*wx*C % 1024 == 0 is enough
    oy, ox, b = probe.make_origins(np.random.RandomState(0), 2 * G, KSHAPE, 16, 6,
                                   "flat", "cpu")
    got = probe.window_sum(wide, oy, ox, b, 16, 6, "flat", g=G)
    ref = jax_probe_steps(wide.float().numpy(), oy.numpy(), ox.numpy(), b.numpy(),
                          16, 6, "flat", G)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_work_counts_each_touched_cell_once(wide):
    oy = torch.tensor([0, 0, 10, 40] * 2, dtype=torch.int32)
    ox = torch.tensor([0, 8, 0, 99] * 2, dtype=torch.int32)
    b = torch.tensor([0, 0, 0, 2] * 2, dtype=torch.int32)
    nbytes, flops = probe.work_of(wide, oy, ox, b, 8, 16, "3d", g=G)
    # image 0: rows 0-7 x columns 0-23 and rows 10-17 x columns 0-15; image 2:
    # the window clamped to rows 40-47, columns 48-63; two output rows
    cells = 8 * 24 + 8 * 16 + 8 * 16
    assert nbytes == cells * 256 * 2 + 2 * 1024 * 4 + 8 * 12
    assert flops == 8 * 8 * 16 * 256


def test_probe_main_refuses_to_run_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main()
