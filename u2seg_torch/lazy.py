"""LazyConfig: python-file configs with deferred construction (the port's copy
of the framework-neutral ``u2seg_tpu/config/lazy.py``). The port's
``config.py`` stays one module; this sits beside it as ``u2seg_torch.lazy``.

Counterpart of ``detectron2/config/lazy.py`` (LazyCall :25, LazyConfig.load/
save/apply_overrides :174) and ``instantiate.py:37`` (recursive
instantiate). A config file is a python module evaluated in isolation; any
``LazyCall(target)(**kwargs)`` node records the target + kwargs and is
constructed recursively by :func:`instantiate`.
"""
from __future__ import annotations

import ast
import builtins
import importlib
import os
import uuid
from typing import Any, Dict

_TARGET_KEY = "_target_"


class LazyCall:
    """LazyCall(T)(a=1) -> {"_target_": T, "a": 1} (a plain dict node)."""

    def __init__(self, target):
        if not (callable(target) or isinstance(target, str)):
            raise TypeError(f"target must be callable or str, got {target!r}")
        self._target = target

    def __call__(self, **kwargs):
        node = dict(kwargs)
        node[_TARGET_KEY] = self._target
        return node


def locate(name: str):
    """Dotted path -> python object (ref utils/registry.py:40 locate)."""
    parts = name.split(".")
    for i in range(len(parts), 0, -1):
        try:
            module = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        obj = module
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(f"Cannot locate {name}")


def instantiate(cfg: Any) -> Any:
    """Recursively build objects from LazyCall dicts (ref instantiate.py:37)."""
    if isinstance(cfg, list):
        return [instantiate(x) for x in cfg]
    if isinstance(cfg, tuple):
        return tuple(instantiate(x) for x in cfg)
    if isinstance(cfg, dict):
        if _TARGET_KEY in cfg:
            target = cfg[_TARGET_KEY]
            if isinstance(target, str):
                target = locate(target)
            kwargs = {
                k: instantiate(v) for k, v in cfg.items() if k != _TARGET_KEY
            }
            return target(**kwargs)
        return {k: instantiate(v) for k, v in cfg.items()}
    return cfg


class LazyConfig:
    @staticmethod
    def load(path: str) -> Dict[str, Any]:
        """Execute a python config file; its module-level names (minus
        dunders/modules) become the config dict."""
        path = os.path.abspath(path)
        with open(path) as f:
            content = f.read()
        module_ns: Dict[str, Any] = {
            "__file__": path,
            "__name__": f"lazyconfig_{uuid.uuid4().hex[:8]}",
            "__builtins__": builtins,
        }
        code = compile(content, path, "exec")
        exec(code, module_ns)
        import types

        return {
            k: v for k, v in module_ns.items()
            if not k.startswith("__") and not isinstance(v, types.ModuleType)
        }

    @staticmethod
    def apply_overrides(cfg: Dict[str, Any], overrides) -> Dict[str, Any]:
        """Dotted-path overrides: ["a.b.c=value", ...]; values parsed as
        python literals with string fallback."""
        for ov in overrides:
            key, _, raw = ov.partition("=")
            try:
                value = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                value = raw
            node = cfg
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p] if isinstance(node, dict) else getattr(node, p)
            if isinstance(node, dict):
                node[parts[-1]] = value
            else:
                setattr(node, parts[-1], value)
        return cfg

    @staticmethod
    def save(cfg: Dict[str, Any], path: str) -> None:
        """Serialize to a python-repr file (callables saved by dotted name)."""

        def clean(x):
            if isinstance(x, dict):
                return {k: clean(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                t = [clean(v) for v in x]
                return t if isinstance(x, list) else tuple(t)
            if callable(x) and hasattr(x, "__module__"):
                return f"{x.__module__}.{x.__qualname__}"
            return x

        with open(path, "w") as f:
            f.write("# saved LazyConfig (targets as dotted strings)\n")
            f.write("cfg = " + repr(clean(cfg)) + "\n")
