"""The benchmark's own tests on the CPU: files found by name, the result
line's keys, the byte and FLOP counts, the import check, and a tiny cell
driven through the harness (the card check skipped), where the reference
agrees with the port and each planted fault makes ``correct`` false.

    python -m pytest portbench/tests -q -p no:cacheprovider
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

from portbench import counts, harness  # noqa: E402
from portbench.tests.tiny import tiny_cell  # noqa: E402


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark(ROOT)


def test_every_file_loads_by_name(bench):
    from portbench.reference_train import read_config_file
    from u2seg_torch.config import load_config

    for cell in bench["workloads"]:
        tr = harness.load_traffic(cell["traffic"])
        harness.load_driver(tr["driver"])
        assert set(tr["limits"]) >= {"init_gap", "proposal_gap"}
        # the loss is compared only where a fault separates it from sound
        # runs (not in u2seg800-train: PERF.md); these in every cell
        for number in ("rpn_head_gap", "grad_scale", "update_scale", "grad_gap",
                       "update_gap", "grad_angle", "update_angle"):
            assert any(k.split("_bf16")[0] == number for k in tr["limits"]), number
    for cfg in bench["configs"]:
        flat, assumed = read_config_file(os.path.join(ROOT, cfg["file"]))
        load_config(None, flat)
        assert "cls_score_tau" in assumed
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_cell_metrics_follow_workload_lists(bench):
    names = {m["name"] for m in harness.cell_metrics(bench, "u2seg800-train", True)}
    assert "mfu.train" in names and "setup_s" not in names
    names = {m["name"] for m in harness.cell_metrics(bench, "u2seg800-train", False)}
    assert names == {"train_images_per_s", "setup_s"}


def test_result_line_keys():
    from portbench.devtrace import Trace
    from portbench.record import Record

    rec = Record(kind="train", setup_s=1.0, window_s=2.0, images=4, steps=2, attempted=4,
                 failed=0, memory_peak_bytes=1, correct=True,
                 checks={"loss_gap": {"value": 0.0, "limit": 1.0}})
    line = harness.result_line(rec, {}, {"platform": "gpu"}, trace=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    rec.trace = Trace(window=(0, 10), kernels=[("k", 2, 5)])
    line = harness.result_line(rec, {}, {"platform": "gpu"}, trace=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device",
                          "breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_k3_bytes_match_the_kernel_table():
    # b=2 at 800x1344: p2-p5 of the FPN, C=256, R=1024 ROIs at s=7
    levels = [(200, 336), (100, 168), (50, 84), (25, 42)]
    got = counts.k3_bytes(levels, batch=2, channels=256, rois=1024, s=7)
    assert abs(got - 234.8e6) / 234.8e6 < 0.01


def test_flop_count_leaves_out_the_pooler():
    class Pooler(torch.nn.Module):
        def forward(self, x):
            return torch.einsum("ij,jk->ik", x, x)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(16, 8, bias=False)
            self.conv = torch.nn.Conv2d(3, 4, 3, bias=False)
            self.pooler = Pooler()

        def forward(self, x, img):
            return self.fc(self.pooler(x)).sum() + self.conv(img).sum()

    net, x, img = Net(), torch.randn(16, 16), torch.randn(1, 3, 10, 10)
    got = counts.counted_flops(lambda: net(x, img))
    assert got == 2 * 16 * 16 * 8 + 2 * 4 * 3 * 9 * 8 * 8


def test_trace_union_and_gaps():
    from portbench.devtrace import Trace

    tr = Trace(window=(0, 100), kernels=[("a", 10, 30), ("b", 20, 40), ("a", 60, 70)],
               ranges=[("pb.data_wait", 40, 60), ("pb.train_step", 0, 100)])
    assert tr.busy_intervals() == [(10, 40), (60, 70)]
    assert abs(tr.busy_s - 40e-9) < 1e-15
    gaps = dict((n, s) for n, s in tr.idle_gaps())
    assert set(gaps) == {"pb.data_wait", "pb.train_step"}
    assert tr.top_kernels()[0][0] == "a"


def test_import_check():
    assert harness.forbidden_modules(["jax", "jax.numpy", "jaxlib.xla", "flax", "optax",
                                      "u2seg_tpu", "u2seg_tpu.models"]) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla", "optax", "u2seg_tpu", "u2seg_tpu.models"]
    assert harness.forbidden_modules(["u2seg_torch", "u2seg_torch.models", "jaxtyping",
                                      "portbench.harness"]) == []


def test_no_card_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(harness.RunFailed):
        harness.check_device(1)


def _tiny_run(tmp_path, seed=7, trace=0):
    cfg, tr = tiny_cell(str(tmp_path))
    args = harness.parse_args(["--workload", "u2seg800-train", "--seed", str(seed),
                               "--seconds", "0.5", "--trace", str(trace)])
    return harness.run_cell(args, time.perf_counter(), device="cpu", config_file=cfg,
                            traffic=tr)


@pytest.fixture
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_reference_agrees_with_the_port(tmp_path, threads):
    rec, metrics = _tiny_run(tmp_path, seed=2 ** 31 + 5, trace=1)
    assert rec.correct, rec.checks
    for name, c in rec.checks.items():
        assert c["value"] <= 1e-4, (name, c)
    assert set(metrics) >= {"data_wait_ms.train", "launches_per_step.train",
                            "device_idle.train", "mfu.train"}
    assert rec.untraced_flops > 0 and rec.untraced_steps >= 1 and rec.steps >= 1
    json.dumps(harness.result_line(rec, metrics, {}, True))


def test_state_left_unchanged_is_not_correct(tmp_path, threads, monkeypatch):
    from u2seg_torch import solver

    monkeypatch.setattr(solver.ScheduledSGD, "step", lambda self, closure=None: None)
    rec, _ = _tiny_run(tmp_path)
    assert not rec.correct
    assert any(c["value"] > c["limit"] for k, c in rec.checks.items()
               if k.startswith("update_gap"))


def test_negated_update_is_not_correct(tmp_path, threads, monkeypatch):
    from u2seg_torch import solver

    inner = solver.ScheduledSGD.step

    @torch.no_grad()
    def negated(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        before = [p.clone() for p in params]
        out = inner(self, closure)
        for p, q in zip(params, before):
            p.copy_(2 * q - p)
        return out

    monkeypatch.setattr(solver.ScheduledSGD, "step", negated)
    rec, _ = _tiny_run(tmp_path)
    assert not rec.correct
    assert any(c["value"] > c["limit"] for k, c in rec.checks.items()
               if k.startswith("update_angle"))


def test_doubled_learning_rate_is_not_correct(tmp_path, threads, monkeypatch):
    from u2seg_torch import solver

    inner = solver.build_lr_schedule
    monkeypatch.setattr(solver, "build_lr_schedule",
                        lambda cfg: (lambda count, f=inner(cfg): 2 * f(count)))
    rec, _ = _tiny_run(tmp_path)
    assert not rec.correct
    assert any(c["value"] > c["limit"] for k, c in rec.checks.items()
               if k.startswith("update_scale"))


def test_parts_and_head_gap():
    from portbench import reference_train as rt

    assert rt.leaf_part("backbone.bottom_up.res2.0.conv1.weight") == "backbone.bottom_up"
    assert rt.leaf_part("backbone.fpn_lateral3.weight") == "backbone.fpn"
    assert rt.leaf_part("roi_heads.box_head.2.fc1.weight") == "roi_heads.box_head.2"
    # a box stage's predictor belongs to its box head
    assert rt.leaf_part("roi_heads.box_predictor.2.bbox_pred.bias") == "roi_heads.box_head.2"
    assert rt.leaf_part("roi_heads.box_predictor.cls_score.weight") == "roi_heads.box_head"
    assert rt.leaf_part("roi_heads.mask_head.deconv.bias") == "roi_heads.mask_head"
    assert rt.leaf_part("sem_seg_head.p5.0.norm.weight") == "sem_seg_head"
    # one part of three wrong: the median over all leaves hides it, the
    # largest part median does not
    keep = [f"a.{i}" for i in range(4)] + [f"b.{i}" for i in range(4)] + ["c.0", "c.1"]
    values = [0.0] * 8 + [1.0, 1.0]
    parts = rt.by_part(values, keep)
    assert max(parts.values()) == 1.0 and sorted(values)[len(values) // 2] == 0.0
    ref = [([torch.ones(1, 3, 4, 4)], [torch.ones(1, 12, 4, 4)])]
    assert rt.rpn_head_gap(ref, ref) == 0.0
    off = [([torch.ones(1, 3, 4, 4) * 1.5], [torch.ones(1, 12, 4, 4)])]
    assert abs(rt.rpn_head_gap(off, ref) - 0.5) < 1e-12
    # only the first step, where both sides hold the same weights, counts
    assert rt.rpn_head_gap(ref + off, ref + ref) == 0.0
    assert rt.rpn_head_gap([], ref) == 1.0


def test_half_batch_is_not_correct(tmp_path, threads, monkeypatch):
    from u2seg_torch.models.panoptic_fpn import PanopticFPN

    inner = PanopticFPN.losses

    def half(self, images, image_sizes, gt, sem_seg_gt, generator=None):
        return inner(self, images[:1], image_sizes[:1], gt[:1], sem_seg_gt[:1], generator)

    monkeypatch.setattr(PanopticFPN, "losses", half)
    rec, _ = _tiny_run(tmp_path)
    assert not rec.correct, rec.checks


def test_every_seed_asks_the_same_work(tmp_path):
    from portbench import traffic

    _, tr = tiny_cell(str(tmp_path))
    seen = []
    for seed in (1, 2 ** 31 + 11):
        out = traffic.write_train_set(str(tmp_path / str(seed)), tr, seed)
        with open(out["paths"]["instances"]) as f:
            js = json.load(f)
        seen.append(sorted((im["height"], im["width"],
                            sum(a["image_id"] == im["id"] for a in js["annotations"]))
                           for im in js["images"]))
    assert seen[0] == seen[1]
