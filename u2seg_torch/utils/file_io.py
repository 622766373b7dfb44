"""Path abstraction with registerable URI-scheme handlers (a copy of the
framework-neutral ``u2seg_tpu/utils/file_io.py``).

Counterpart of ``detectron2/utils/file_io.py`` (iopath ``PathManager`` with
the ``detectron2://`` catalog handler :16). No model-zoo download catalog
(checkpoints are local files), so the built-in scheme is ``u2seg://`` which resolves inside a
local cache root (``$U2SEG_CACHE`` or ``~/.cache/u2seg``) — the place
converted reference checkpoints and dataset fixtures live.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, IO, List


class PathHandler:
    """Maps URIs of one scheme prefix to concrete local paths."""

    PREFIX = ""

    def get_local_path(self, path: str) -> str:
        raise NotImplementedError

    def open(self, path: str, mode: str = "r") -> IO:
        return open(self.get_local_path(path), mode)


class NativePathHandler(PathHandler):
    def get_local_path(self, path: str) -> str:
        return path


class U2SegCacheHandler(PathHandler):
    """``u2seg://rel/path`` -> ``$U2SEG_CACHE/rel/path``."""

    PREFIX = "u2seg://"

    def get_local_path(self, path: str) -> str:
        root = os.environ.get(
            "U2SEG_CACHE", os.path.expanduser("~/.cache/u2seg"))
        return os.path.join(root, path[len(self.PREFIX):])


class _PathManager:
    def __init__(self):
        self._native = NativePathHandler()
        self._handlers: Dict[str, PathHandler] = {}

    def register_handler(self, handler: PathHandler) -> None:
        if not handler.PREFIX:
            raise ValueError("handler must define a non-empty PREFIX")
        self._handlers[handler.PREFIX] = handler

    def _handler(self, path: str) -> PathHandler:
        for prefix, h in self._handlers.items():
            if path.startswith(prefix):
                return h
        return self._native

    def get_local_path(self, path: str) -> str:
        return self._handler(path).get_local_path(path)

    def open(self, path: str, mode: str = "r") -> IO:
        local = self.get_local_path(path)
        if any(m in mode for m in "wax"):
            os.makedirs(os.path.dirname(local) or ".", exist_ok=True)
        return open(local, mode)

    def exists(self, path: str) -> bool:
        return os.path.exists(self.get_local_path(path))

    def isfile(self, path: str) -> bool:
        return os.path.isfile(self.get_local_path(path))

    def isdir(self, path: str) -> bool:
        return os.path.isdir(self.get_local_path(path))

    def ls(self, path: str) -> List[str]:
        return sorted(os.listdir(self.get_local_path(path)))

    def mkdirs(self, path: str) -> None:
        os.makedirs(self.get_local_path(path), exist_ok=True)

    def rm(self, path: str) -> None:
        os.remove(self.get_local_path(path))

    def copy(self, src: str, dst: str) -> None:
        shutil.copyfile(self.get_local_path(src), self.get_local_path(dst))


PathManager = _PathManager()
PathManager.register_handler(U2SegCacheHandler())
