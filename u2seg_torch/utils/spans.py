"""Named spans of the program's stages on the profiler's timeline.

``span(name)`` marks a block as a user range of ``torch.profiler`` (the
Chrome trace's ``user_annotation``, copied onto the card's timeline as
``gpu_user_annotation``) while a profiler records, and is one shared null
context otherwise: a block outside a profile pays a check of the profiler's
state and nothing else, and ``torch.export`` and ``torch.fx`` see no node.
There is no switch: spans exist exactly when a profiler runs (the operator's
``engine.hooks.ProfilerHook``, a benchmark's, or any other).

A span's ``args`` (numbers) are recorded as the range's inputs: a profiler
that records shapes shows them as its "Concrete Inputs" (``u2s.step``
carries its iteration). A span entered while a profiler ran closes cleanly
after the profiler stopped, and one entered before a profiler started
records nothing, so hooks may start and stop profilers inside a span.

Names start with ``u2s.``. A training iteration, as ``TrainerBase.train``
and ``DefaultTrainer`` run it::

    u2s.step                  before-hooks, run_step, after-hooks (args: iteration)
      u2s.hook.<Hook>         one hook's before_step or after_step
      u2s.data                the next batch from the loader
      u2s.upload              the batch as tensors, on the device
      u2s.forward             training mode, zero_grad, the model's losses, their sum
        u2s.backbone          trunk and FPN
        u2s.sem_seg           the sem-seg head and its loss
        u2s.rpn               RPN head, anchors, losses, proposals
          u2s.rpn.nms         the batched NMS
        u2s.roi_heads.sample  proposals matched to the ground truth and sampled
        u2s.roi_heads.stage<k> one box stage: pool, head, predictor, loss
        u2s.roi_heads.mask    the mask (and keypoint) losses
      u2s.backward            the backward pass (and the all-reduce over processes)
      u2s.optimizer           the update
        u2s.optimizer.clip    gradient clipping
      u2s.metrics             the losses to the host, the NaN check, the storage
    u2s.gc                    a pause of Python's garbage collector (``GcSpans``)

The model's spans sit in the model code, so an inference forward carries
``u2s.backbone``, ``u2s.sem_seg``, ``u2s.rpn``, ``u2s.rpn.nms``,
``u2s.roi_heads.stage<k>`` and ``u2s.roi_heads.mask`` too.
"""
from __future__ import annotations

import contextlib
import gc
import threading

import torch

PREFIX = "u2s."
NULL = contextlib.nullcontext()
_enabled = torch.autograd._profiler_enabled


class _Span:
    """One user range: ``torch.profiler.record_function``'s enter and exit
    with numeric arguments, which a profiler that records shapes keeps."""

    __slots__ = ("name", "args", "handle")

    def __init__(self, name: str, args: tuple):
        self.name, self.args = name, args

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(self.name, *self.args)
        return self

    def __exit__(self, *exc):
        torch.autograd._record_function_with_args_exit(self.handle)
        return False


def span(name: str, args=None):
    """A context that marks its block as the range ``name`` while a profiler
    records; ``NULL`` otherwise. ``args``: a number or a tuple of numbers."""
    if not _enabled():
        return NULL
    if args is None:
        args = ()
    elif not isinstance(args, tuple):
        args = (args,)
    return _Span(name, args)


class GcSpans:
    """``with GcSpans():`` marks every collection of Python's garbage
    collector on the entering thread as a ``u2s.gc`` range, while a profiler
    records (``gc.callbacks``' start and stop). Collections on other threads
    (loader workers) are left out."""

    def __init__(self):
        self._thread = None
        self._open = None

    def _callback(self, phase, info):
        if threading.get_ident() != self._thread:
            return
        if phase == "start":
            if _enabled():
                self._open = _Span(PREFIX + "gc", ()).__enter__()
        elif self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None

    def __enter__(self):
        self._thread = threading.get_ident()
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)
        return False
