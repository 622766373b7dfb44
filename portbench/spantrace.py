"""The program's own spans and the host's waits for the card in a traced
window: a ``devtrace.Trace`` extended from the same profiler events, so
that everything lies on one timeline (kineto's host and device events on
one clock).

``u2seg_torch`` opens ranges named ``u2s.*`` around its stages while a
profiler records (``u2seg_torch/utils/spans.py``): ``u2s.step`` around each
training iteration, and inside it the hooks, data, upload, forward (and its
model stages), backward, optimizer and metrics, and ``u2s.gc`` around
Python's garbage collections. ``extend(trace, events)`` adds to a
``devtrace.Trace``:

- ``spans``: the host ranges whose names start with ``u2s.`` (the card's
  copies of them are left out of ``kernels`` already, as the benchmark's
  ``pb.`` copies are);
- ``syncs``: the CUDA runtime calls that block the host on the card
  (``SYNC_CALLS``);
- ``launches``: for each kernel, copy and fill on the card, the host time of
  the runtime call that launched it, linked by the call's correlation id.

Its ``idle_gaps`` label a gap by the innermost range of either prefix open
when the gap began; ``kernels``, ``ranges`` and ``window`` are the base
trace's, so every reader of a ``Trace`` reads the same values from it.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from portbench.devtrace import Interval, Trace, _is_kernel

SPAN_PREFIX = "u2s."
STEP = "u2s.step"
# the runtime calls after which the host holds until the card has caught up
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})
# the benchmark's own hook (``drivers/train.py``'s ``Window``): not the program's
BENCHMARK_HOOK = "u2s.hook.Window"
HOST = "host"

Launch = Tuple[int, int, int, bool]      # launch ns, start ns, end ns, a kernel


@dataclass
class ProgramTrace(Trace):
    spans: List[Interval] = field(default_factory=list)
    syncs: List[Interval] = field(default_factory=list)
    launches: List[Launch] = field(default_factory=list)

    # -- labels --------------------------------------------------------
    def labeller(self):
        """-> ``label(t)``: the innermost range of either prefix open at ``t``
        (the latest-started one that has not ended), or ``HOST``."""
        ranges = sorted(self.ranges + self.spans, key=lambda r: r[1])
        starts = [r[1] for r in ranges]

        def label(t: int) -> str:
            for name, s, e in reversed(ranges[:bisect.bisect_right(starts, t)]):
                if e > t:
                    return name
            return HOST

        return label

    def gaps(self) -> List[Tuple[int, int]]:
        """Every idle gap of the card inside the window, in order."""
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest idle gaps, each named by the innermost range of
        either prefix open when it began."""
        label = self.labeller()
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return [[label(s), (e - s) * 1e-9] for s, e in gaps]

    def idle_by_span(self) -> Dict[str, int]:
        """Idle ns of the window summed by the label of each gap (the range
        open when it began); the values sum to the window's idle time."""
        label = self.labeller()
        out: Dict[str, int] = {}
        for s, e in self.gaps():
            name = label(s)
            out[name] = out.get(name, 0) + (e - s)
        return out

    def idle_over_spans(self) -> Dict[str, int]:
        """Idle ns of the window split by the innermost range open at each
        instant of each gap: what the host was doing while the card idled."""
        bounds = sorted({x for _, s, e in self.ranges + self.spans for x in (s, e)})
        label = self.labeller()
        out: Dict[str, int] = {}
        for s, e in self.gaps():
            cuts = [s] + bounds[bisect.bisect_right(bounds, s):bisect.bisect_left(bounds, e)] + [e]
            for a, b in zip(cuts, cuts[1:]):
                if b > a:
                    name = label(a)
                    out[name] = out.get(name, 0) + (b - a)
        return out

    def device_ns_by_span(self) -> Dict[str, int]:
        """Kernel ns of the window by the innermost range open when the
        kernel was launched (its runtime call, by correlation id)."""
        label = self.labeller()
        lo, hi = self.window
        out: Dict[str, int] = {}
        for launch, s, e, kernel in self.launches:
            if kernel and lo <= s < hi:
                name = label(launch)
                out[name] = out.get(name, 0) + (e - s)
        return out

    def syncs_by_span(self) -> Dict[str, int]:
        """Syncs of the window by the innermost range open when they began."""
        label = self.labeller()
        out: Dict[str, int] = {}
        for _, s, _ in self.syncs:
            name = label(s)
            out[name] = out.get(name, 0) + 1
        return out

    # -- whole steps ---------------------------------------------------
    def steps(self) -> List[Tuple[int, int]]:
        """The ``u2s.step`` spans that lie whole inside the window: the
        profiler starts and stops inside a hook, so the first and last
        traced steps may lack theirs."""
        lo, hi = self.window
        return sorted((s, e) for name, s, e in self.spans
                      if name == STEP and lo <= s and e <= hi)

    def in_steps(self, items) -> list:
        """The intervals of ``items`` that lie inside one whole step."""
        steps = self.steps()
        starts = [s for s, _ in steps]
        out = []
        for it in items:
            i = bisect.bisect_right(starts, it[1]) - 1
            if i >= 0 and it[2] <= steps[i][1]:
                out.append(it)
        return out

    def host_ns_by_span(self) -> Dict[str, int]:
        """Host ns of each span name inside whole steps (a span's children
        included)."""
        out: Dict[str, int] = {}
        for name, s, e in self.in_steps(self.spans):
            out[name] = out.get(name, 0) + (e - s)
        return out

    def step_syncs(self) -> int:
        """Syncs that began and ended inside whole steps."""
        return len(self.in_steps(self.syncs))

    def uncovered_ns(self) -> int:
        """The part of the whole steps that no span inside them covers."""
        total = 0
        for lo, hi in self.steps():
            inner = sorted((max(s, lo), min(e, hi)) for name, s, e in self.spans
                           if name != STEP and s < hi and e > lo)
            covered, end = 0, lo
            for s, e in inner:
                if e > end:
                    covered += e - max(s, end)
                    end = e
            total += (hi - lo) - covered
        return total

    def sync_lags(self) -> List[int]:
        """For each sync that began while the card still had work launched
        before it, ns from the end of that work to the sync's end: with host
        and card on one clock these lie at or a little above 0."""
        done = sorted((launch, e) for launch, _, e, _ in self.launches)
        launch_t = [d[0] for d in done]
        ends, last = [], 0
        for _, e in done:
            last = max(last, e)
            ends.append(last)
        out = []
        for _, s, e in self.syncs:
            i = bisect.bisect_left(launch_t, s)
            if i and ends[i - 1] > s:
                out.append(e - ends[i - 1])
        return out


def extend(trace: Trace, events) -> ProgramTrace:
    """``trace`` (``devtrace.Profiler``'s reduction of ``events``) with the
    program's spans, the host's syncs and every device operation's launch
    time, from the same ``events`` (``kineto_results.events()``)."""
    from torch.autograd import DeviceType

    out = ProgramTrace(window=trace.window, kernels=trace.kernels, ranges=trace.ranges)
    # the card's copies of host ranges carry the ranges' names
    annotations = {ev.name() for ev in events if ev.device_type() == DeviceType.CPU
                   and ev.is_user_annotation()}
    calls: Dict[int, int] = {}
    device = []
    for ev in events:
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CPU:
            if name.startswith(SPAN_PREFIX):
                out.spans.append((name, s, e))
            elif name.startswith("cu"):              # a CUDA runtime or driver call
                calls[ev.correlation_id()] = s
                if name in SYNC_CALLS:
                    out.syncs.append((name, s, e))
        elif (ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation()
              and name not in annotations):
            device.append((ev.correlation_id(), s, e, _is_kernel(name)))
    for corr, s, e, kernel in device:
        launch = calls.get(corr)
        if launch is not None:
            out.launches.append((launch, s, e, kernel))
    return out


# -- the program's per-step readings -----------------------------------------

def program_trace(record) -> Optional[ProgramTrace]:
    """The record's trace where it holds the program's spans and whole steps."""
    tr = getattr(record, "trace", None)
    if record.kind != "train" or not isinstance(tr, ProgramTrace) or not tr.steps():
        return None
    return tr


def host_ms_per_step(record, names) -> Optional[float]:
    """Host ms per whole step in the spans named ``names`` (a name ending in
    ``.`` takes every span it starts)."""
    tr = program_trace(record)
    if tr is None:
        return None
    by_name = tr.host_ns_by_span()
    ns = sum(v for k, v in by_name.items()
             if any(k == n or (n.endswith(".") and k.startswith(n)) for n in names)
             and k != BENCHMARK_HOOK)
    return ns * 1e-6 / len(tr.steps())


def syncs_per_step(record) -> Optional[float]:
    tr = program_trace(record)
    if tr is None:
        return None
    return tr.step_syncs() / len(tr.steps())
