"""The device trace of a traced window: ``torch.profiler`` over the CPU and
the card, reduced to kernel intervals, the benchmark's own host ranges, and
the union of the intervals (the time the device was busy).

Host ranges are the ``record_function`` ranges the benchmark opens around
each call into a layer; their names start with ``pb.``. An idle gap of the
device is labelled by the innermost such range open on the host when the gap
began.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

Interval = Tuple[str, int, int]          # name, start ns, end ns

RANGE_PREFIX = "pb."
WINDOW = "pb.window"


@dataclass
class Trace:
    window: Tuple[int, int]                    # ns: the traced window's range
    kernels: List[Interval] = field(default_factory=list)
    ranges: List[Interval] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of kernel intervals, clipped to the window, in order."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.kernels)
        out: List[Tuple[int, int]] = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                if e > out[-1][1]:
                    out[-1] = (out[-1][0], e)
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_seconds(self, part: str = "") -> float:
        """Device seconds of the kernels whose name holds ``part``."""
        return sum(e - s for n, s, e in self.kernels if part in n) * 1e-9

    def top_kernels(self, n: int = 10) -> List[list]:
        total: Dict[str, int] = {}
        for name, s, e in self.kernels:
            total[name] = total.get(name, 0) + (e - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest idle gaps of the device inside the window, each
        named by the innermost benchmark range open when it began."""
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        ranges = sorted(self.ranges, key=lambda r: r[1])
        starts = [r[1] for r in ranges]
        out = []
        for s, e in gaps[:n]:
            label = "host"
            i = bisect.bisect_right(starts, s)
            best = None
            for name, rs, re_ in ranges[:i]:
                if re_ > s and (best is None or rs >= best[1]):
                    best = (name, rs)
            if best is not None:
                label = best[0]
            out.append([label, (e - s) * 1e-9])
        return out


def _is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


class Profiler:
    """``with Profiler() as p: ...`` traces the block; ``p.trace`` is the
    ``Trace`` of it afterwards."""

    def __init__(self, device: str = "cuda"):
        self.device = device
        self.trace: Optional[Trace] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._window = record_function(WINDOW)
        self._window.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()
        self._window.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = self._reduce()
        return False

    def _reduce(self) -> Trace:
        from torch.autograd import DeviceType

        events = self._prof.profiler.kineto_results.events()
        # host ranges are CPU events (the card's copies of them are not)
        window = [(ev.start_ns(), ev.start_ns() + ev.duration_ns()) for ev in events
                  if ev.name() == WINDOW and ev.device_type() == DeviceType.CPU]
        if len(window) != 1:
            raise RuntimeError(f"the trace holds {len(window)} window ranges")
        tr = Trace(window=window[0])
        # the card's copies of host ranges carry the ranges' names
        annotations = {ev.name() for ev in events if ev.device_type() == DeviceType.CPU
                       and ev.is_user_annotation()}
        for ev in events:
            name = ev.name()
            s = ev.start_ns()
            e = s + ev.duration_ns()
            if ev.device_type() == DeviceType.CUDA:
                if _is_kernel(name) and not ev.is_user_annotation() and name not in annotations:
                    tr.kernels.append((name, s, e))
            elif (ev.device_type() == DeviceType.CPU and name.startswith(RANGE_PREFIX)
                  and name != WINDOW):
                tr.ranges.append((name, s, e))
        return tr
