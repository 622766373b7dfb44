"""Build and load the port's CUDA kernels.

Each ``u2seg_torch/csrc/<name>.cu`` has a plain C interface. At first use it
is compiled with ``nvcc`` for ``sm_90a`` into
``build/u2seg_torch_kernels/lib<name>-<hash>.so`` (the hash covers the
source, every header ``csrc/*.cuh`` and the flags, so an edit of any of them
rebuilds) and loaded with ``ctypes``. Sources include headers from ``csrc/``
(``-I``).
Pointers and the stream cross the boundary as ``c_void_p``. Nothing here runs
at import time: the CPU tests import every module of the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "u2seg_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_path(name: str) -> str:
    """``csrc/<name>.cu``, or ``name`` itself where it is a path to a
    ``.cu`` file elsewhere (a development build of another version)."""
    if name.endswith(".cu"):
        return os.path.abspath(name)
    return os.path.join(CSRC_DIR, name + ".cu")


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    stem = os.path.basename(name)[:-3] if name.endswith(".cu") else name
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source (see ``source_path``) that is not built
    yet, one ``nvcc`` per source, all started together. Returns name -> path
    of the library; the compiler's report (``-Xptxas=-v``) sits beside it as
    ``.log``."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = f"{p}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, source_path(n)]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        with open(paths[n] + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{source_path(n)} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``source_path(name)``, built first if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(build([name])[name])
    return _LIBS[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        lib.u2seg_cuda_error_string.restype = ctypes.c_char_p
        msg = lib.u2seg_cuda_error_string(ctypes.c_int(code)).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
