"""Dataset and metadata catalogs (counterpart of
``u2seg_tpu/data/catalog.py``; detectron2's ``data/catalog.py``).

A name -> loader-function registry and a name -> metadata namespace. The
port keeps registries of its own: a dataset registered in the JAX package
is not seen here.
"""
from __future__ import annotations

import copy
import types
from typing import Any, Callable, Dict, List


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, func: Callable[[], List[dict]]):
        assert callable(func), "must register a callable"
        if name in self._registry:
            raise KeyError(f"Dataset '{name}' already registered")
        self._registry[name] = func

    def get(self, name: str) -> List[dict]:
        try:
            f = self._registry[name]
        except KeyError:
            raise KeyError(
                f"Dataset '{name}' not registered. Available: "
                f"{sorted(self._registry)[:20]}"
            )
        return f()

    def list(self) -> List[str]:
        return sorted(self._registry)

    def remove(self, name: str):
        self._registry.pop(name)

    def clear(self):
        self._registry.clear()

    def __contains__(self, name: str) -> bool:
        return name in self._registry


class Metadata(types.SimpleNamespace):
    """Attribute namespace; set-once semantics like the reference."""

    name: str = "N/A"

    def get(self, key, default=None):
        return getattr(self, key, default)

    def set(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def as_dict(self):
        return copy.copy(self.__dict__)


class _MetadataCatalog:
    def __init__(self):
        self._registry: Dict[str, Metadata] = {}

    def get(self, name: str) -> Metadata:
        if name not in self._registry:
            self._registry[name] = Metadata(name=name)
        return self._registry[name]

    def list(self) -> List[str]:
        return sorted(self._registry)

    def remove(self, name: str):
        self._registry.pop(name)

    def clear(self):
        self._registry.clear()


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
