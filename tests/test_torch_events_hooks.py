"""u2seg_torch's event storage, writers, trainer base and hooks against the
JAX package's (counterpart of ``tests/engine/test_events_hooks.py``): the same
call sequences through both give equal values, equal ``metrics.json`` lines,
the same hook order and the same periods. Neither side runs a model.
"""
import json
import os

import numpy as np
import pytest
import torch

from u2seg_tpu.config.config import SolverConfig as JSolverConfig
from u2seg_tpu.engine import events as jevents
from u2seg_tpu.engine import hooks as jhooks
from u2seg_tpu.engine import train_loop as jtrain_loop
from u2seg_tpu.solver import build_lr_schedule as jbuild_lr_schedule
from u2seg_torch.config import SolverConfig
from u2seg_torch.engine import events, hooks, train_loop
from u2seg_torch.solver import build_lr_schedule

SIDES = {"jax": (jevents, jhooks, jtrain_loop), "torch": (events, hooks, train_loop)}


def drive_storage(ev, seed=0, n=60):
    """A seeded sequence of puts, steps and smoothing hints; -> the storage
    and what it reports along the way."""
    rng = np.random.RandomState(seed)
    seen = []
    with ev.EventStorage(3) as s:
        assert ev.get_event_storage() is s
        for _ in range(n):
            name = ["loss_a", "loss_b", "lr", "acc"][rng.randint(4)]
            if rng.rand() < 0.3:
                s.put_scalars(smoothing_hint=bool(rng.rand() < 0.5),
                              **{name: float(rng.randn()), "extra": float(rng.rand())})
            else:
                s.put_scalar(name, float(rng.randn() * 3), smoothing_hint=name != "lr")
            if rng.rand() < 0.5:
                s.step()
            window = int(rng.randint(1, 25))
            seen.append((s.iter, s.latest(), s.latest_with_smoothing_hint(window)))
    return s, seen


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_event_storage_matches_jax(seed):
    (ref, ref_seen), (got, got_seen) = drive_storage(jevents, seed), drive_storage(events, seed)
    assert got_seen == ref_seen
    assert sorted(got.histories()) == sorted(ref.histories())
    for k, h in ref.histories().items():
        g = got.history(k)
        assert g.values() == h.values() and g.latest() == h.latest()
        assert g.global_avg() == h.global_avg()
        for w in (None, 1, 3, 20, 50):
            assert g.median(w) == h.median(w) and g.avg(w) == h.avg(w)


def test_history_buffer_window_matches_jax():
    ref, got = jevents.HistoryBuffer(window=5), events.HistoryBuffer(window=5)
    for i, v in enumerate(np.random.RandomState(3).randn(40)):
        ref.update(float(v), i)
        got.update(float(v), i)
        assert (got.median(), got.avg(), got.global_avg()) == (
            ref.median(), ref.avg(), ref.global_avg())


def write_metrics(ev, path, window):
    rng = np.random.RandomState(7)
    w = ev.JSONWriter(path, window_size=window)
    with ev.EventStorage(0) as s:
        for it in range(12):
            s.put_scalar("total_loss", float(rng.rand()), smoothing_hint=True)
            s.put_scalar("lr", 0.01 * (it + 1), smoothing_hint=False)
            if it % 3 == 0:
                s.put_scalar("time", float(rng.rand()))
            if it % 4 == 3:
                w.write(s)
            s.step()
        w.write(s)
    w.close()
    return open(path).read().splitlines()


@pytest.mark.parametrize("window", [1, 20])
def test_json_writer_lines_match_jax(tmp_path, window):
    ref = write_metrics(jevents, str(tmp_path / "jax" / "metrics.json"), window)
    got = write_metrics(events, str(tmp_path / "torch" / "metrics.json"), window)
    assert got == ref
    # a line for every iteration that holds the newest value of some scalar
    assert [json.loads(l)["iteration"] for l in got] == [3, 6, 7, 9, 11]


def fake_trainer(side):
    _, _, tl = SIDES[side]

    class Fake(tl.TrainerBase):
        def run_step(self):
            self.storage.put_scalar("loss", 10.0 / (self.iter + 1))

    return Fake()


def recorder(side, order):
    _, hk, _ = SIDES[side]

    class Recorder(hk.HookBase):
        def before_train(self):
            order.append("before_train")

        def before_step(self):
            order.append(f"before_{self.trainer.iter}")

        def after_step(self):
            order.append(f"after_{self.trainer.iter}")

        def after_train(self):
            order.append(f"after_train_{self.trainer.iter}")

    return Recorder()


@pytest.mark.parametrize("start,end", [(0, 3), (2, 5), (4, 4)])
def test_trainer_base_hook_order_matches_jax(start, end):
    orders = {}
    for side in SIDES:
        orders[side] = order = []
        t = fake_trainer(side)
        t.register_hooks([recorder(side, order), None, recorder(side, order)])
        t.train(start, end)
        orders[side].append(("iter", t.iter, t.storage.iter, t.state_dict()["iteration"]))
    assert orders["torch"] == orders["jax"]
    assert orders["torch"][0] == "before_train" and orders["torch"][1] == "before_train"


class Counter:
    def __init__(self):
        self.calls = []

    def write(self, storage):
        self.calls.append(storage.iter)

    def close(self):
        self.calls.append("close")

    def save(self, name, state):
        self.calls.append(name)


@pytest.mark.parametrize("period,max_iter", [(2, 6), (3, 7), (1, 3), (5, 4)])
def test_periods_of_eval_writer_and_checkpointer_match_jax(period, max_iter):
    seen = {}
    for side in SIDES:
        _, hk, _ = SIDES[side]
        evals, writer, ckpt = [], Counter(), Counter()
        t = fake_trainer(side)
        t.save_state = lambda: {}
        t.register_hooks([
            hk.EvalHook(period, lambda: evals.append(1) or {"m": {"x": 1.0, "s": "no"}}),
            hk.PeriodicWriter([writer], period=period),
            hk.PeriodicCheckpointer(ckpt, period),
        ])
        t.train(0, max_iter)
        seen[side] = (len(evals), writer.calls, ckpt.calls,
                      t.storage.history("m/x").values())
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0] >= 1


def test_best_checkpointer_matches_jax():
    seen = {}
    for side in SIDES:
        _, hk, tl = SIDES[side]
        ckpt = Counter()
        values = iter([0.3, 0.5, 0.4, 0.7, 0.1, 0.9])

        class Fake(tl.TrainerBase):
            def run_step(self):
                self.storage.put_scalar("ap", next(values))

            def save_state(self):
                return {}

        t = Fake()
        best = hk.BestCheckpointer(2, ckpt, "ap", mode="max")
        t.register_hooks([best])
        t.train(0, 6)
        seen[side] = (ckpt.calls, best.state_dict())
    assert seen["torch"] == seen["jax"] == (["model_best"] * 3, {"best": 0.9})


@pytest.mark.parametrize("overrides", [
    {},                                                       # the u2seg recipe
    {"scheduler": "WarmupCosineLR", "max_iter": 40, "warmup_iters": 5},
    {"warmup_method": "constant", "steps": (3, 9), "gamma": 0.5, "warmup_iters": 4},
])
def test_lr_logger_matches_jax_schedule(overrides):
    lrs = {}
    for side, cfg in (("jax", JSolverConfig()), ("torch", SolverConfig())):
        for k, v in overrides.items():
            setattr(cfg, k, v)
        sched = (jbuild_lr_schedule if side == "jax" else build_lr_schedule)(cfg)
        _, hk, _ = SIDES[side]
        t = fake_trainer(side)
        t.register_hooks([hk.LRLogger(sched)])
        t.train(0, 12)
        lrs[side] = [v for v, _ in t.storage.history("lr").values()]
    np.testing.assert_allclose(lrs["torch"], lrs["jax"], rtol=1e-6)


@pytest.mark.parametrize("results", [
    {"a": {"b": 1.0, "c": {"d": 2}}, "e": 3},
    {"bbox": {"AP": np.float32(41.5), "AP50": 60}, "name": "x", "n": None},
    {},
])
def test_flatten_results_dict_matches_jax(results):
    got = hooks.flatten_results_dict(results)
    assert got == jhooks.flatten_results_dict(results)
    assert all(isinstance(v, float) for v in got.values())


def test_iteration_timer_skips_warmup_like_jax():
    counts = {}
    for side in SIDES:
        _, hk, _ = SIDES[side]
        t = fake_trainer(side)
        t.register_hooks([hk.IterationTimer(warmup_iter=2)])
        t.train(1, 6)
        counts[side] = [it for _, it in t.storage.history("time").values()]
    assert counts["torch"] == counts["jax"] == [3, 4, 5]


def test_memory_stats_hook_puts_nothing_for_a_cpu_device():
    t = fake_trainer("torch")
    t.device = torch.device("cpu")
    t.register_hooks([hooks.MemoryStatsHook(period=1)])
    t.train(0, 2)
    assert "mem_mb" not in t.storage.histories()


def test_profiler_hook_writes_a_chrome_trace(tmp_path):
    t = fake_trainer("torch")
    t.register_hooks([hooks.ProfilerHook(lambda it: it in (1, 2), str(tmp_path))])
    t.train(0, 4)
    (trace,) = os.listdir(tmp_path)
    assert trace == "trace_0000001-0000002.json"
    with open(tmp_path / trace) as f:
        assert "traceEvents" in json.load(f)


def test_common_metric_printer_logs_a_line(caplog):
    with events.EventStorage(4) as s:
        s.put_scalar("loss_cls", 0.5)
        s.put_scalar("time", 0.25)
        s.put_scalar("lr", 0.01, smoothing_hint=False)
        with caplog.at_level("INFO", logger=events.__name__):
            events.CommonMetricPrinter(max_iter=10).write(s)
    assert "iter: 4" in caplog.text and "loss_cls: 0.5" in caplog.text
    assert "lr: 0.01" in caplog.text and "eta: 0:00:01" in caplog.text
