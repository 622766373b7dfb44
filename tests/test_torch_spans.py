"""The port's spans (``u2seg_torch/utils/spans.py``) and the benchmark's
reading of them (``portbench/spantrace.py``).

- ``span()`` outside a profile is one shared null context and enters no
  range; a span closes cleanly across a profiler's start and stop;
- a tiny ``DefaultTrainer`` step under ``torch.profiler`` records the span
  tree: every name, each child inside its parent, one ``u2s.step`` per step
  with its iteration as the range's input, one ``u2s.roi_heads.stage<k>``
  per cascade stage, at most 40 spans a step besides the collector's;
- ``u2s.gc`` marks collections on the training thread only;
- ``ProfilerHook``'s Chrome trace holds the spans;
- on synthetic profiler events: gaps labelled by the innermost range of
  either prefix, syncs counted, idle time summed by label, kernels
  attributed to spans by correlation id, the five program readers'
  values, and the benchmark's existing readers bit-equal with and without
  the program's spans and their copies on the card;
- on the card (``cuda`` marker): one planted ``.item()`` a step reads
  ``host_syncs_per_step.train`` exactly one higher.

No JAX: the card runs this file with ``--noconftest``.
"""
import gc
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import devtrace, harness, spantrace  # noqa: E402
from portbench.record import Record  # noqa: E402
from u2seg_torch import config as tconfig  # noqa: E402
from u2seg_torch.engine import hooks as hooks_lib  # noqa: E402
from u2seg_torch.engine.train_loop import DefaultTrainer  # noqa: E402
from u2seg_torch.testing import fake_loader  # noqa: E402
from u2seg_torch.utils import spans  # noqa: E402

PROGRAM_READERS = ["host_syncs_per_step.train", "forward_host_ms.train",
                   "backward_host_ms.train", "optimizer_host_ms.train",
                   "step_overhead_ms.train"]
EXISTING_READERS = ["data_wait_ms.train", "launches_per_step.train", "mfu.train",
                    "k3_roofline.train", "device_idle.train"]
# child -> parent in one training iteration
TREE = {
    "u2s.data": "u2s.step", "u2s.upload": "u2s.step", "u2s.forward": "u2s.step",
    "u2s.backward": "u2s.step", "u2s.optimizer": "u2s.step", "u2s.metrics": "u2s.step",
    "u2s.backbone": "u2s.forward", "u2s.sem_seg": "u2s.forward", "u2s.rpn": "u2s.forward",
    "u2s.rpn.nms": "u2s.rpn", "u2s.roi_heads.sample": "u2s.forward",
    "u2s.roi_heads.stage0": "u2s.forward", "u2s.roi_heads.stage1": "u2s.forward",
    "u2s.roi_heads.stage2": "u2s.forward", "u2s.roi_heads.mask": "u2s.forward",
    "u2s.optimizer.clip": "u2s.optimizer",
    "u2s.hook.IterationTimer": "u2s.step", "u2s.hook.LRLogger": "u2s.step",
    "u2s.hook.PeriodicCheckpointer": "u2s.step", "u2s.hook.PeriodicWriter": "u2s.step",
}


def small_cfg(out_dir, device_pooler=False):
    """An 8-block trunk, narrow widths, 7 classes, the 3-stage cascade,
    masks, f32."""
    cfg = tconfig.Config()
    m = cfg.model
    m.compute_dtype = "float32"
    m.resnet.norm = "BN"
    m.fpn.norm = "BN"
    m.resnet.depth = 18
    m.resnet.width_per_group = 8
    m.resnet.stem_out_channels = 16
    m.resnet.res2_out_channels = 32
    m.fpn.out_channels = 32
    m.roi_heads.num_classes = 7
    m.roi_heads.box_head.fc_dim = 64
    m.roi_heads.mask_head.conv_dim = 32
    if not device_pooler:
        m.roi_heads.pooler_impl = "gather"
    m.sem_seg_head.conv_dim = 32
    m.sem_seg_head.num_classes = 5
    m.rpn.pre_nms_topk_train = 64
    m.rpn.post_nms_topk_train = 64
    m.roi_heads.batch_size_per_image = 64
    cfg.solver.warmup_iters = 2
    cfg.solver.checkpoint_period = 100
    cfg.output_dir = str(out_dir)
    return cfg


def trainer(out_dir, device="cpu", hooks=True, extra_hooks=()):
    t = DefaultTrainer(small_cfg(out_dir), fake_loader(np.random.RandomState(2), b=2),
                       device=device)
    t.register_hooks((t.build_hooks() if hooks else []) + list(extra_hooks))
    return t


@pytest.fixture
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def host_ranges(prof):
    return sorted(((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                    ev.concrete_inputs())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.device_type() == DeviceType.CPU and ev.name().startswith("u2s.")),
                  key=lambda r: r[1])


# -- the span helper ---------------------------------------------------------

def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def fail(*a):
        raise AssertionError("a range was entered with no profiler running")

    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter", fail)
    assert not torch.autograd._profiler_enabled()
    for args in (None, 3, (1, 2.5)):
        s = spans.span("u2s.x", args)
        assert s is spans.NULL
        with s:
            pass
    with spans.GcSpans():
        gc.collect()


def test_span_closes_across_the_profiler_start_and_stop():
    p = profile(activities=[ProfilerActivity.CPU])
    with spans.span("u2s.before"):          # entered with no profiler: records nothing
        p.__enter__()
        with spans.span("u2s.inside", 7):
            torch.ones(2).sum()
        with spans.span("u2s.across"):      # entered on, closed after the stop
            p.__exit__(None, None, None)
    names = [r[0] for r in host_ranges(p)]
    assert names == ["u2s.inside", "u2s.across"]


def test_gc_spans_mark_the_entering_thread_only():
    with profile(activities=[ProfilerActivity.CPU]) as p, spans.GcSpans():
        gc.collect()
        t = threading.Thread(target=gc.collect)
        t.start()
        t.join(10)
        assert not t.is_alive()
    assert [r[0] for r in host_ranges(p)] == ["u2s.gc"]


# -- the span tree of a training step -----------------------------------------

def test_training_steps_record_the_span_tree(tmp_path, threads):
    t = trainer(tmp_path)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        t.train(max_iter=2)
    ranges = host_ranges(p)
    steps = [r for r in ranges if r[0] == "u2s.step"]
    assert [r[3] for r in steps] == [[0], [1]]
    for lo, hi in [(s, e) for _, s, e, _ in steps]:
        inside = [r for r in ranges if lo <= r[1] and r[2] <= hi and r[0] != "u2s.step"]
        names = [r[0] for r in inside]
        assert set(TREE) <= set(names)
        # one of each model stage a step, hooks before and after the step
        for name in TREE:
            assert names.count(name) == (2 if name.startswith("u2s.hook.") else 1), name
        assert len([n for n in names if n != "u2s.gc"]) <= 40
        for name, s, e, _ in inside:
            if name in TREE and TREE[name] != "u2s.step":
                parent = [r for r in inside if r[0] == TREE[name]]
                assert any(ps <= s and e <= pe for _, ps, pe, _ in parent), name
        # the stages run in order
        stages = [r for r in inside if r[0].startswith("u2s.roi_heads.stage")]
        assert [r[0] for r in stages] == [f"u2s.roi_heads.stage{k}" for k in range(3)]
    # every range but the collector's (before and after training too) lies in a step
    assert all(any(s <= r[1] and r[2] <= e for _, s, e, _ in steps)
               for r in ranges if r[0] != "u2s.gc")


def test_profiler_hook_trace_holds_the_spans(tmp_path, threads):
    # the hook starts its profiler inside iteration 1's step and stops it
    # inside iteration 2's: the trace holds iteration 2's step whole
    hook = hooks_lib.ProfilerHook(lambda it: it in (1, 2), str(tmp_path / "traces"))
    trainer(tmp_path, extra_hooks=[hook]).train(max_iter=3)
    (path,) = list((tmp_path / "traces").iterdir())
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {ev.get("name") for ev in events if ev.get("cat") == "user_annotation"}
    assert set(TREE) - {"u2s.hook.IterationTimer", "u2s.hook.LRLogger",
                        "u2s.hook.PeriodicCheckpointer", "u2s.hook.PeriodicWriter"} <= names
    assert "u2s.step" in names


# -- the benchmark's reading, on synthetic events -----------------------------

class Ev:
    """The part of a kineto event that ``devtrace`` and ``spantrace`` read."""

    def __init__(self, name, s, e, device="cpu", annotation=False, corr=0):
        self._n, self._s, self._d = name, s, e - s
        self._dev = DeviceType.CUDA if device == "cuda" else DeviceType.CPU
        self._a, self._c = annotation, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._a

    def correlation_id(self):
        return self._c


def base_events():
    """A window 0-1000 of one step in the benchmark's ranges: a data wait,
    a train step with four kernels (one launched in the NMS, which waits for
    it), a fill, and the losses' copy read back with a sync."""
    return [
        Ev("pb.window", 0, 1000, annotation=True),
        Ev("pb.run_step", 10, 990, annotation=True),
        Ev("pb.data_wait", 20, 60, annotation=True),
        Ev("pb.train_step", 100, 900, annotation=True),
        Ev("aten::add", 108, 116, corr=1),
        Ev("cudaLaunchKernel", 110, 115, corr=1),
        Ev("cudaLaunchKernel", 210, 214, corr=6),
        Ev("cudaStreamSynchronize", 215, 265, corr=7),
        Ev("cudaLaunchKernel", 300, 305, corr=2),
        Ev("cudaMemsetAsync", 310, 312, corr=3),
        Ev("cudaLaunchKernel", 885, 887, corr=8),
        Ev("cudaMemcpyAsync", 920, 925, corr=4),
        Ev("cudaStreamSynchronize", 926, 980, corr=5),
        Ev("gemm", 120, 250, device="cuda", corr=1),
        Ev("nms_tile", 250, 262, device="cuda", corr=6),
        Ev("roi_align_ml_backward_kernel", 320, 400, device="cuda", corr=2),
        Ev("Memset (Device)", 312, 318, device="cuda", corr=3),
        Ev("sgd", 890, 910, device="cuda", corr=8),
        Ev("Memcpy DtoH (Device -> Pinned)", 930, 975, device="cuda", corr=4),
    ]


SPANS = [("u2s.step", 5, 995), ("u2s.data", 15, 70), ("u2s.upload", 70, 100),
         ("u2s.forward", 105, 290), ("u2s.rpn", 115, 280), ("u2s.rpn.nms", 200, 260),
         ("u2s.backward", 290, 880), ("u2s.gc", 500, 520), ("u2s.optimizer", 880, 905),
         ("u2s.metrics", 905, 990)]


def program_events():
    """The program's spans of the same step and their copies on the card
    (some marked as annotations, all carrying the host ranges' names)."""
    return ([Ev(n, s, e, annotation=True) for n, s, e in SPANS]
            + [Ev(n, s + 3, e + 3, device="cuda", annotation=i % 2 == 0)
               for i, (n, s, e) in enumerate(SPANS)])


class FakeProfile:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {"events": lambda _: events})()


def reduce(events, program=False):
    prof = devtrace.Profiler("cuda")
    prof._prof = FakeProfile(events)
    tr = prof._reduce()
    return spantrace.extend(tr, events) if program else tr


def record(tr, traced_steps=1):
    return Record(kind="train", setup_s=1.0, window_s=2.0, images=4, steps=2, attempted=4,
                  failed=0, memory_peak_bytes=1, data_wait_s=[0.1, 0.2], trace=tr,
                  traced_steps=traced_steps, untraced_s=2e-6, untraced_steps=2,
                  untraced_flops=1e6, k3_bytes=1e3, k3_calls=1)


def test_existing_readers_read_the_same_with_the_programs_spans():
    plain = reduce(base_events())
    traces = [reduce(base_events() + program_events()),
              reduce(base_events(), program=True),
              reduce(base_events() + program_events(), program=True)]
    # the card's copies of the program's ranges are no kernels
    for tr in traces:
        assert tr.kernels == plain.kernels and tr.ranges == plain.ranges
        assert tr.window == plain.window
    names = EXISTING_READERS + ["setup_s", "train_images_per_s"]
    want = {n: harness.load_reader(n)(record(plain)) for n in names}
    assert all(v is not None for v in want.values())
    for tr in traces:
        assert {n: harness.load_reader(n)(record(tr)) for n in names} == want
    # the benchmark's own view of the gaps is the same; the program's names them
    assert traces[0].idle_gaps() == plain.idle_gaps()
    assert [d for _, d in traces[2].idle_gaps()] == [d for _, d in plain.idle_gaps()]


def test_gaps_are_labelled_by_the_innermost_range_of_either_prefix():
    tr = reduce(base_events() + program_events(), program=True)
    assert tr.gaps() == [(0, 120), (262, 320), (400, 890), (910, 1000)]
    label = tr.labeller()
    assert [label(s) for s, _ in tr.gaps()] == ["host", "u2s.rpn", "u2s.backward",
                                                 "u2s.metrics"]
    assert [n for n, _ in tr.idle_gaps()] == ["u2s.backward", "host", "u2s.metrics",
                                              "u2s.rpn"]
    # inside the benchmark's wait for data, the innermost is its own range
    assert label(30) == "pb.data_wait" and label(65) == "u2s.data"
    plain = reduce(base_events())
    assert [n for n, _ in plain.idle_gaps()] == ["pb.train_step", "host", "pb.run_step",
                                                 "pb.train_step"]


def test_idle_by_span_sums_to_the_windows_idle_time():
    tr = reduce(base_events() + program_events(), program=True)
    idle_ns = 1000 - round(tr.busy_s * 1e9)
    assert idle_ns == 758
    assert tr.idle_by_span() == {"host": 120, "u2s.rpn": 58, "u2s.backward": 490,
                                 "u2s.metrics": 90}
    over = tr.idle_over_spans()
    assert sum(over.values()) == idle_ns
    assert over == {"host": 10, "u2s.step": 10, "pb.run_step": 5, "u2s.data": 15,
                    "pb.data_wait": 40, "u2s.upload": 30, "pb.train_step": 5,
                    "u2s.forward": 20, "u2s.rpn": 23, "u2s.backward": 490, "u2s.gc": 20,
                    "u2s.optimizer": 10, "u2s.metrics": 80}


def test_syncs_are_counted_and_kernels_attributed_by_correlation_id():
    tr = reduce(base_events() + program_events(), program=True)
    assert tr.syncs == [("cudaStreamSynchronize", 215, 265),
                        ("cudaStreamSynchronize", 926, 980)]
    assert tr.step_syncs() == 2
    assert tr.syncs_by_span() == {"u2s.rpn.nms": 1, "u2s.metrics": 1}
    # a kernel counts where it was launched, not where the card ran it
    assert tr.device_ns_by_span() == {"u2s.forward": 130, "u2s.rpn.nms": 12,
                                      "u2s.backward": 80, "u2s.optimizer": 20}
    host = tr.host_ns_by_span()
    assert (host["u2s.step"], host["u2s.forward"], host["u2s.gc"]) == (990, 185, 20)
    assert tr.steps() == [(5, 995)]
    assert tr.uncovered_ns() == 20
    # each sync ends a few ns after the work it waited for
    assert tr.sync_lags() == [265 - 262, 980 - 975]


def test_program_readers_return_their_values():
    tr = reduce(base_events() + program_events(), program=True)
    got = {name: harness.load_reader(name)(record(tr)) for name in PROGRAM_READERS}
    assert got == pytest.approx({"host_syncs_per_step.train": 2.0,
                                 "forward_host_ms.train": 185e-6,
                                 "backward_host_ms.train": 590e-6,
                                 "optimizer_host_ms.train": 25e-6,
                                 "step_overhead_ms.train": (30 + 85) * 1e-6}, rel=1e-12)
    # the benchmark's own hook is not the program's overhead
    hooked = reduce(base_events() + program_events()
                    + [Ev("u2s.hook.Window", 990, 993, annotation=True),
                       Ev("u2s.hook.PeriodicWriter", 993, 994, annotation=True)],
                    program=True)
    assert harness.load_reader("step_overhead_ms.train")(record(hooked)) == pytest.approx(
        (30 + 85 + 1) * 1e-6, rel=1e-12)
    # a trace without the program's view, or without a whole step: nothing
    for other in (reduce(base_events() + program_events()),
                  reduce(base_events(), program=True)):
        assert all(harness.load_reader(n)(record(other)) is None for n in PROGRAM_READERS)


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_a_planted_item_reads_one_more_sync_a_step(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: it counts the card's runtime calls")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        counts = []
        for planted in (False, True):
            t = trainer(tmp_path / str(planted), device="cuda", hooks=False)
            inner = t.step_fn

            def step_fn(batch, generator=None, inner=inner, planted=planted):
                out = inner(batch, generator)
                if planted:
                    torch.ones((), device="cuda").item()
                return out

            t.step_fn = step_fn
            t.train(max_iter=1)                     # builds, warms the allocator
            prof = devtrace.Profiler("cuda")
            with prof:
                t.train(max_iter=4)
            events = prof._prof.profiler.kineto_results.events()
            tr = spantrace.extend(prof.trace, events)
            steps = tr.steps()
            assert len(steps) == 4
            counts.append([sum(1 for _, s, e in tr.syncs if lo <= s and e <= hi)
                           for lo, hi in steps])
            rec = record(tr)
            assert harness.load_reader("host_syncs_per_step.train")(rec) == sum(counts[-1]) / 4
        assert [b - a for a, b in zip(*counts)] == [1, 1, 1, 1], counts
    finally:
        torch.use_deterministic_algorithms(False)
