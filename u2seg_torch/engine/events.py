"""Metrics storage and writers (counterpart of ``u2seg_tpu/engine/events.py``).

``EventStorage`` keeps a windowed history per scalar name, with a smoothing
hint that decides whether writers read the window's median or the latest
value; ``JSONWriter`` appends one JSON line per written iteration to
``metrics.json``; ``CommonMetricPrinter`` logs a console line;
``TensorboardWriter`` writes scalars through ``torch.utils.tensorboard``.
"""
from __future__ import annotations

import datetime
import json
import logging
import os
from collections import defaultdict, deque
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

_CURRENT_STORAGE_STACK: List["EventStorage"] = []


def get_event_storage() -> "EventStorage":
    assert _CURRENT_STORAGE_STACK, "get_event_storage() called outside a storage context"
    return _CURRENT_STORAGE_STACK[-1]


class HistoryBuffer:
    """Windowed scalar history with median/avg smoothing."""

    def __init__(self, window: int = 20):
        self._window = window
        self._values: deque = deque(maxlen=1_000_000)
        self._recent: deque = deque(maxlen=window)
        self._count = 0
        self._global_avg = 0.0

    def update(self, value: float, iteration: int):
        self._values.append((value, iteration))
        self._recent.append(value)
        self._count += 1
        self._global_avg += (value - self._global_avg) / self._count

    def latest(self) -> float:
        return self._values[-1][0]

    def median(self, window: Optional[int] = None) -> float:
        vals = sorted(list(self._recent)[-(window or self._window):])
        return vals[len(vals) // 2] if vals else 0.0

    def avg(self, window: Optional[int] = None) -> float:
        vals = list(self._recent)[-(window or self._window):]
        return sum(vals) / len(vals) if vals else 0.0

    def global_avg(self) -> float:
        return self._global_avg

    def values(self):
        return list(self._values)


class EventStorage:
    """Scalars of the running loop, by name and iteration; a context
    manager that makes itself the current storage."""

    def __init__(self, start_iter: int = 0):
        self._histories: Dict[str, HistoryBuffer] = defaultdict(HistoryBuffer)
        self._smoothing_hints: Dict[str, bool] = {}
        self._iter = start_iter
        self._latest: Dict[str, tuple] = {}

    @property
    def iter(self) -> int:
        return self._iter

    @iter.setter
    def iter(self, v: int):
        self._iter = int(v)

    def step(self):
        self._iter += 1

    def put_scalar(self, name: str, value, smoothing_hint: bool = True):
        value = float(value)
        self._histories[name].update(value, self._iter)
        self._latest[name] = (value, self._iter)
        self._smoothing_hints[name] = smoothing_hint

    def put_scalars(self, *, smoothing_hint: bool = True, **kwargs):
        for k, v in kwargs.items():
            self.put_scalar(k, v, smoothing_hint)

    def history(self, name: str) -> HistoryBuffer:
        return self._histories[name]

    def histories(self):
        return self._histories

    def latest(self):
        return dict(self._latest)

    def latest_with_smoothing_hint(self, window: int = 20):
        out = {}
        for k, (v, it) in self._latest.items():
            out[k] = (
                self._histories[k].median(window)
                if self._smoothing_hints.get(k) else v,
                it,
            )
        return out

    def __enter__(self):
        _CURRENT_STORAGE_STACK.append(self)
        return self

    def __exit__(self, *args):
        assert _CURRENT_STORAGE_STACK[-1] is self
        _CURRENT_STORAGE_STACK.pop()


class EventWriter:
    def write(self, storage: EventStorage):
        raise NotImplementedError

    def close(self):
        pass


class JSONWriter(EventWriter):
    """Appends one JSON line per written iteration to ``json_file``."""

    def __init__(self, json_file: str, window_size: int = 20):
        os.makedirs(os.path.dirname(json_file) or ".", exist_ok=True)
        self._file = open(json_file, "a")
        self._window = window_size
        self._last_write = -1

    def write(self, storage: EventStorage):
        to_save = defaultdict(dict)
        for k, (v, it) in storage.latest_with_smoothing_hint(self._window).items():
            if it <= self._last_write:
                continue
            to_save[it][k] = v
        if to_save:
            self._last_write = max(to_save.keys())
        for it in sorted(to_save):
            rec = {"iteration": it, **to_save[it]}
            self._file.write(json.dumps(rec, sort_keys=True) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()


class CommonMetricPrinter(EventWriter):
    """Console line: eta, iteration, losses (median), step time, lr."""

    def __init__(self, max_iter: Optional[int] = None, window_size: int = 20):
        self._max_iter = max_iter
        self._window = window_size

    def write(self, storage: EventStorage):
        it = storage.iter
        histories = storage.histories()
        eta = tstr = lr = ""
        if "time" in histories:
            t = histories["time"]
            if self._max_iter and t.global_avg() > 0:
                eta_s = t.global_avg() * (self._max_iter - it - 1)
                eta = f"eta: {datetime.timedelta(seconds=int(eta_s))}  "
            tstr = f"time: {t.avg(self._window):.4f}  "
        if "lr" in histories:
            lr = f"lr: {histories['lr'].latest():.5g}  "
        losses = [f"{k}: {h.median(self._window):.4g}"
                  for k, h in histories.items() if "loss" in k]
        logger.info("%siter: %d  %s  %s%s", eta, it, "  ".join(losses), tstr, lr)


class TensorboardWriter(EventWriter):
    """TensorBoard scalars through ``torch.utils.tensorboard`` (raises
    ImportError where the ``tensorboard`` package is absent)."""

    def __init__(self, log_dir: str, window_size: int = 20):
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(log_dir)
        self._window = window_size
        self._last_write = -1

    def write(self, storage: EventStorage):
        new_last = self._last_write
        for k, (v, it) in storage.latest_with_smoothing_hint(self._window).items():
            if it > self._last_write:
                self._writer.add_scalar(k, v, it)
                new_last = max(new_last, it)
        self._last_write = new_last
        self._writer.flush()

    def close(self):
        self._writer.close()
