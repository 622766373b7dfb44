"""The ViTDet cell's own tests on the CPU: the attention readers on a
synthetic trace (and on a trace without the program's spans, where they
read nothing), the attention count from shapes, and the tiny ViTDet cell
driven through the harness (the card check skipped), where the reference
agrees with the port and a fault planted in the program makes ``correct``
false; on the card (marked ``cuda``), the cell at its own size, where the
control and each planted fault of ``refvitdet.replay.FAULTS`` read not
correct.

    python -m pytest portbench/tests -q -p no:cacheprovider
    python3 -m pytest --noconftest -p no:cacheprovider -m cuda portbench/tests
"""
import json
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import counts, counts_vitdet, harness, spantrace  # noqa: E402
from portbench.devtrace import Trace  # noqa: E402
from portbench.drivers.train_vitdet import ViTRecord, ViTTrace  # noqa: E402
from portbench.tests.tiny_vitdet import tiny_cell  # noqa: E402

CELL = "vitdet-l-train"


def _record(trace, flops=0.0) -> ViTRecord:
    return ViTRecord(kind="train", setup_s=1.0, window_s=1.0, images=4, steps=1,
                     attempted=4, failed=0, memory_peak_bytes=0, trace=trace,
                     traced_steps=2, attn_flops=flops)


def _synthetic() -> ViTTrace:
    """Two steps: attention spans launching a GEMM and the fused forward,
    the MLP's GEMM, backward kernels launched inside the attention's
    backward nodes and outside them, and one past the window."""
    tr = ViTTrace(window=(0, 10_000))
    tr.spans = [("u2s.step", 0, 5_000), ("u2s.vit.attn.window", 100, 200),
                ("u2s.vit.attn.global", 300, 400), ("u2s.vit.mlp", 420, 440),
                ("u2s.step", 5_000, 10_000)]
    tr.attn_backward = [(5_200, 5_300), (5_100, 5_150)]
    tr.kernels = [("sm90_gemm_bf16", 1_000, 1_300), ("fmha_cutlassF_bf16_aligned", 1_300, 1_800),
                  ("fmha_cutlassF_bf16_aligned", 2_000, 2_500), ("sm90_gemm_bf16", 2_600, 2_700),
                  ("fmha_cutlassB_bf16_aligned_64x64", 6_000, 7_000),
                  ("reduce_kernel", 7_000, 7_400), ("gelu_backward", 7_400, 7_500),
                  ("fmha_cutlassB_bf16_aligned_64x64", 10_000, 10_900)]
    tr.launches = [(110, 1_000, 1_300, True), (120, 1_300, 1_800, True),
                   (310, 2_000, 2_500, True), (430, 2_600, 2_700, True),
                   (5_120, 6_000, 7_000, True), (5_250, 7_000, 7_400, True),
                   (5_170, 7_400, 7_500, True), (5_260, 9_900, 9_950, False),
                   (5_290, 10_000, 10_900, True)]
    return tr


def _reader(name):
    return harness.load_reader(name)


def test_attention_readers_on_a_synthetic_trace():
    rec = _record(_synthetic(), flops=1e9)
    # forward: 300 + 500 + 500 ns inside the spans (the MLP's GEMM not);
    # backward: 1000 + 400 ns launched inside the attention's nodes (not the
    # GELU's outside them, the copy, nor the kernel past the window); over 2
    # traced steps
    ms = _reader("attn_ms.train")(rec)
    assert ms == pytest.approx(2_700e-6 / 2)
    share = _reader("attn_peak_share.train")(rec)
    assert share == pytest.approx(100 * 1e9 / (ms * 1e-3 * counts.PEAK_BF16_FLOPS))
    # a trace whose backward nodes were not linked reads nothing
    tr = _synthetic()
    tr.attn_backward = []
    assert _reader("attn_ms.train")(_record(tr, flops=1e9)) is None


def test_attention_backward_nodes_on_profiled_blocks(threads):
    """On the CPU profiler's own events of a windowed and a global block,
    forward and backward: the nodes linked to the attention spans are the
    attention's (qkv, SDPA, the rel-pos terms and their table lookups, proj,
    the padding) and none of the norms', the MLP's or the residual sums'."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.drivers.train_vitdet import EVALUATE, attention_backward
    from u2seg_torch.models.vit import ViTBlock

    torch.manual_seed(0)
    blocks = [ViTBlock(32, 4, window_size=4, rel_pos=(4, 4), sdpa=True),
              ViTBlock(32, 4, window_size=0, rel_pos=(6, 6), sdpa=True)]
    x = torch.randn(2, 6, 6, 32, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = x
        for blk in blocks:
            y = blk(y)
        y.sum().backward()
    events = prof.profiler.kineto_results.events()
    found = attention_backward(events)
    assert found == sorted(found) and all(s < e for s, e in found)
    names = {ev.name()[len(EVALUATE):] for ev in events if ev.name().startswith(EVALUATE)
             and (ev.start_ns(), ev.start_ns() + ev.duration_ns()) in found}
    assert {"AddmmBackward0", "ConstantPadNdBackward0"} <= names, names
    # SDPA with a bias runs its math form on the CPU: a softmax between two bmm
    assert any("Softmax" in n or "Attention" in n for n in names), names
    assert "BmmBackward0" in names and "IndexBackward0" in names, names
    assert not names & {"NativeLayerNormBackward0", "GeluBackward0", "SumBackward0"}, names
    # both blocks: four addmm nodes (qkv and proj of each)
    addmm = [ev for ev in events if ev.name() == EVALUATE + "AddmmBackward0"
             and (ev.start_ns(), ev.start_ns() + ev.duration_ns()) in found]
    assert len(addmm) == 4


def test_attention_readers_read_nothing_without_spans():
    plain = Trace(window=(0, 10), kernels=[("fmha_cutlassB_bf16", 1, 5)])
    for name in ("attn_ms.train", "attn_peak_share.train"):
        assert _reader(name)(_record(plain, flops=1e9)) is None
        assert _reader(name)(_record(None)) is None
    # a parent's record (no ``attn_flops``) reads nothing either
    from portbench.record import Record

    old = Record(kind="train", setup_s=1.0, window_s=1.0, images=4, steps=1, attempted=4,
                 failed=0, memory_peak_bytes=0, trace=_synthetic(), traced_steps=2)
    assert _reader("attn_peak_share.train")(old) is None


@pytest.mark.parametrize("rel_pos", [True, False])
def test_attention_flops_from_shapes(rel_pos):
    fwd, bwd = counts_vitdet.attention_flops(4, (64, 64), 1024, 16, 24, 14, (5, 11, 17, 23),
                                             rel_pos)
    # 25 padded 14 x 14 windows an image; a global block over 4096 tokens
    windowed = (2.0 * 19_600 * 1024 * 3072 + 2.0 * 19_600 * 1024 * 1024
                + 4.0 * (4 * 25) * 16 * 196 * 196 * 64
                + rel_pos * 2.0 * (4 * 25) * 16 * 196 * 28 * 64)
    global_ = (2.0 * 16_384 * 1024 * 3072 + 2.0 * 16_384 * 1024 * 1024
               + 4.0 * 4 * 16 * 4096 * 4096 * 64 + rel_pos * 2.0 * 4 * 16 * 4096 * 128 * 64)
    assert fwd == pytest.approx(20 * windowed + 4 * global_)
    assert bwd == 2 * fwd


def test_cell_metrics_and_files():
    bench = harness.load_benchmark(ROOT)
    names = {m["name"] for m in harness.cell_metrics(bench, CELL, True)}
    assert names == {"data_wait_ms.train", "launches_per_step.train", "mfu.train",
                     "k3_roofline.train", "device_idle.train", "attn_ms.train",
                     "attn_peak_share.train"}
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, False)} == {
        "train_images_per_s", "setup_s"}
    tr = harness.load_traffic(CELL)
    assert tr["driver"] == "train_vitdet"
    harness.load_driver(tr["driver"])


@pytest.fixture
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny_run(tmp_path, seed=7, trace=0):
    cfg, tr = tiny_cell(str(tmp_path))
    args = harness.parse_args(["--workload", CELL, "--seed", str(seed), "--seconds", "0.5",
                               "--trace", str(trace)])
    return harness.run_cell(args, time.perf_counter(), device="cpu", config_file=cfg,
                            traffic=tr)


def test_reference_agrees_with_the_port(tmp_path, threads):
    rec, metrics = _tiny_run(tmp_path, seed=2 ** 31 + 5, trace=1)
    assert rec.correct, rec.checks
    for name, c in rec.checks.items():
        assert c["value"] <= 1e-5, (name, c)
    assert set(metrics) >= {"data_wait_ms.train", "mfu.train", "device_idle.train"}
    assert rec.untraced_flops > 0 and rec.attn_flops > 0
    assert isinstance(rec.trace, ViTTrace) and rec.trace.attn_backward
    assert {n for n, _, _ in rec.trace.spans} >= {
        "u2s.vit.patch", "u2s.vit.attn.window", "u2s.vit.attn.global", "u2s.vit.mlp",
        "u2s.backbone.pyramid"}
    json.dumps(harness.result_line(rec, metrics, {}, True))


def test_rel_pos_left_out_is_not_correct(tmp_path, threads, monkeypatch):
    from u2seg_torch.models import vit

    monkeypatch.setattr(vit, "decomposed_rel_pos", lambda q, hw, h, w: torch.zeros(
        *q.shape[:-1], q.shape[-2], dtype=q.dtype))
    rec, _ = _tiny_run(tmp_path)
    assert not rec.correct, rec.checks


def test_half_batch_is_not_correct(tmp_path, threads, monkeypatch):
    from u2seg_torch.models.rcnn import GeneralizedRCNN

    inner = GeneralizedRCNN.losses_from_features

    def half(self, features, image_sizes, gt, generator=None):
        return inner(self, {k: v[:1] for k, v in features.items()}, image_sizes[:1], gt[:1],
                     generator)

    monkeypatch.setattr(GeneralizedRCNN, "losses_from_features", half)
    rec, _ = _tiny_run(tmp_path)
    assert not rec.correct, rec.checks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_faults_and_control_are_not_correct(card):
    """At the cell's own size: the program correct, and the control and
    each fault of ``refvitdet.replay.FAULTS`` not correct, on one seed."""
    from portbench import reference_train as rt
    from portbench.refvitdet import replay

    args = harness.parse_args(["--workload", CELL, "--seed", "2718281828", "--seconds", "0",
                               "--trace", "0"])
    rec, _ = harness.run_cell(args, time.perf_counter())
    assert rec.correct, rec.checks
    x = rec.extra
    limits = harness.load_traffic(CELL)["limits"]
    kw = dict(proposals=x["proposals"], state=x["state"])

    def fails(got) -> list:
        numbers = replay.compare_both(got, x["reference"], x["reference16"],
                                      x["global_blocks"])
        return [k for k, v in limits.items() if k in numbers and numbers[k] > v]

    assert fails(replay.control_replay(x["ref_cfg"], x["seed"], x["tau"], x["kept"],
                                       "cuda", **kw)), "control"
    own = rt.own_precision(x["ref_cfg"], x["compute_dtype"])
    for fault in replay.FAULTS:
        assert fails(replay.replay(own, x["seed"], x["tau"], x["kept"], "cuda", fault=fault,
                                   **kw)), fault
