"""Generic name->object registry + dotted-path ``locate`` (a copy of the
framework-neutral ``u2seg_tpu/utils/registry.py``).

Counterpart of ``detectron2/utils/registry.py`` (fvcore ``Registry``
re-export + ``locate`` :40). The concrete registries in this package
(``META_ARCH_REGISTRY`` in ``models/build.py``) are plain dicts for zero-import-cost startup; this
class is the extension surface for projects that want the reference's
decorator-registration idiom.
"""
from __future__ import annotations

import pydoc
from typing import Any, Dict, Iterator, Tuple


class Registry:
    """Name -> object mapping supporting decorator or explicit registration.

    >>> MODELS = Registry("MODELS")
    >>> @MODELS.register()
    ... class MyNet: ...
    >>> MODELS.get("MyNet")
    """

    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def _do_register(self, name: str, obj: Any) -> None:
        if name in self._obj_map:
            raise ValueError(
                f"An object named '{name}' was already registered "
                f"in '{self._name}' registry!")
        self._obj_map[name] = obj

    def register(self, obj: Any = None):
        """Decorator (no-arg call) or direct registration (with an object)."""
        if obj is None:
            def deco(func_or_class):
                self._do_register(func_or_class.__name__, func_or_class)
                return func_or_class

            return deco
        self._do_register(obj.__name__, obj)
        return obj

    def get(self, name: str) -> Any:
        ret = self._obj_map.get(name)
        if ret is None:
            raise KeyError(
                f"No object named '{name}' found in '{self._name}' registry!")
        return ret

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def __iter__(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._obj_map.items())

    def __repr__(self) -> str:
        return f"Registry of {self._name}: {sorted(self._obj_map)}"

    keys = lambda self: self._obj_map.keys()  # noqa: E731


def locate(name: str) -> Any:
    """Dotted path -> python object (``detectron2/utils/registry.py:40``).

    Locates ``module.submodule.attr`` strings (``u2seg_torch.*`` among them),
    importing as needed -- the inverse of the dotted names ``lazy.LazyConfig.save``
    writes.
    """
    obj = pydoc.locate(name)
    if obj is None:
        # pydoc.locate gives up on some nested attributes; walk manually.
        parts = name.split(".")
        for i in range(len(parts) - 1, 0, -1):
            mod_name = ".".join(parts[:i])
            try:
                import importlib

                obj = importlib.import_module(mod_name)
            except ImportError:
                continue
            try:
                for attr in parts[i:]:
                    obj = getattr(obj, attr)
                return obj
            except AttributeError:
                obj = None
        raise ImportError(f"Cannot locate object {name!r}")
    return obj
