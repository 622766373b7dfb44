"""Logging setup (a copy of the framework-neutral ``u2seg_tpu/utils/logger.py``).

Counterpart of ``detectron2/utils/logger.py`` (setup_logger :43 with color,
log_first_n :164, log_every_n :199, log_every_n_seconds :218).
"""
from __future__ import annotations

import atexit
import functools
import logging
import os
import sys
import time
from collections import Counter
from typing import Optional

_LOG_COUNTER: Counter = Counter()
_LOG_TIMER: dict = {}


class _ColorFormatter(logging.Formatter):
    GREY = "\x1b[38;20m"
    YELLOW = "\x1b[33;20m"
    RED = "\x1b[31;20m"
    RESET = "\x1b[0m"

    def format(self, record):
        msg = super().format(record)
        if record.levelno >= logging.ERROR:
            return self.RED + msg + self.RESET
        if record.levelno >= logging.WARNING:
            return self.YELLOW + msg + self.RESET
        return msg


@functools.lru_cache()
def setup_logger(
    output: Optional[str] = None,
    distributed_rank: int = 0,
    *,
    color: bool = True,
    name: str = "u2seg_torch",
    abbrev_name: Optional[str] = None,
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    fmt = "[%(asctime)s %(name)s %(levelname)s]: %(message)s"
    datefmt = "%m/%d %H:%M:%S"

    if distributed_rank == 0:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        formatter = (
            _ColorFormatter(fmt, datefmt=datefmt)
            if color and sys.stdout.isatty()
            else logging.Formatter(fmt, datefmt=datefmt)
        )
        ch.setFormatter(formatter)
        logger.addHandler(ch)

    if output is not None:
        filename = output
        if not filename.endswith(".txt") and not filename.endswith(".log"):
            filename = os.path.join(output, "log.txt")
        if distributed_rank > 0:
            filename = filename + f".rank{distributed_rank}"
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        fh = logging.StreamHandler(open(filename, "a"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(fmt, datefmt=datefmt))
        logger.addHandler(fh)
        atexit.register(fh.flush)
    return logger


def _caller_key():
    frame = sys._getframe(2)
    return (frame.f_code.co_filename, frame.f_lineno)


def log_first_n(lvl: int, msg: str, n: int = 1, *, name: Optional[str] = None):
    key = _caller_key() + (msg,)
    _LOG_COUNTER[key] += 1
    if _LOG_COUNTER[key] <= n:
        logging.getLogger(name or "u2seg_torch").log(lvl, msg)


def log_every_n(lvl: int, msg: str, n: int = 1, *, name: Optional[str] = None):
    key = _caller_key()
    _LOG_COUNTER[key] += 1
    if (_LOG_COUNTER[key] - 1) % n == 0:
        logging.getLogger(name or "u2seg_torch").log(lvl, msg)


def log_every_n_seconds(lvl: int, msg: str, n: int = 1, *,
                        name: Optional[str] = None):
    key = _caller_key()
    last = _LOG_TIMER.get(key)
    now = time.time()
    if last is None or now - last >= n:
        _LOG_TIMER[key] = now
        logging.getLogger(name or "u2seg_torch").log(lvl, msg)
