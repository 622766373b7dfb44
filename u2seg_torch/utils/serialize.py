"""Closure-safe serialization wrapper (a copy of the framework-neutral
``u2seg_tpu/utils/serialize.py``).

Counterpart of ``detectron2/utils/serialize.py`` (``PicklableWrapper``
:5). The data loader's worker threads and any multiprocessing mapper need
to ship lambdas/closures across process boundaries; plain pickle rejects
them, cloudpickle serializes by value.
"""
from __future__ import annotations

import pickle

try:  # cloudpickle ships with the baked-in environment
    import cloudpickle
except ImportError:  # pragma: no cover
    cloudpickle = None


class PicklableWrapper:
    """Wraps a callable so it pickles by value (lambdas, local closures).

    Re-wrapping a PicklableWrapper is a no-op; attribute access forwards
    to the wrapped object.
    """

    def __init__(self, obj):
        while isinstance(obj, PicklableWrapper):
            obj = obj._obj
        self._obj = obj

    def __reduce__(self):
        if cloudpickle is None:
            return (PicklableWrapper, (self._obj,))
        return (_unpickle, (cloudpickle.dumps(self._obj),))

    def __call__(self, *args, **kwargs):
        return self._obj(*args, **kwargs)

    def __getattr__(self, attr):
        if attr not in ("_obj",):
            return getattr(self._obj, attr)
        return getattr(super(), attr)  # pragma: no cover


def _unpickle(payload: bytes):
    return PicklableWrapper(pickle.loads(payload))
