"""The host C++ behind mask IoU, box IoU and COCOeval's greedy matching
(counterpart of ``u2seg_tpu/_native``), loaded with ``ctypes``.

``rle_ops.cpp`` is compiled at first use with ``g++ -O3 -march=native
-shared -fPIC -std=c++17 -ffp-contract=off`` into
``build/u2seg_torch_native/librle_ops-<hash>.so``. The hash covers the
source, the flags and what ``-march=native`` resolves to on this machine, so
an edit or another CPU builds anew. The compiler writes a per-pid temporary
that is renamed into place, so processes that build at once (test workers)
leave one library that all of them load. Where ``g++`` is missing or fails,
the first call raises ``RuntimeError`` with the compiler's output: there is
no fallback. The numpy twins (``evaluation/rle.py::_iou_plain``,
``evaluation/coco_eval_core.py::_bbox_iou_xywh`` and ``::_match_plain``)
define the semantics and serve as references in tests.

The wrappers take and return what ``evaluation/rle.py`` does: RLE dicts
whose counts are compressed ``bytes`` / ``str`` or a list of run lengths.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "rle_ops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "u2seg_torch_native")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-ffp-contract=off")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    path = shutil.which(CXX)
    if path is None:
        raise RuntimeError(f"{CXX} not found on PATH: the port's COCO matcher "
                           f"({SOURCE}) is built with {CXX} at first use")
    return path


def library_path() -> str:
    """Where the library for this source, these flags and this CPU lies."""
    cxx = _compiler()
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, timeout=60)
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0"
                            + target.stdout.encode() + b"\0")
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"librle_ops-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``rle_ops.cpp`` unless its library exists; returns its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([_compiler(), *CXX_FLAGS, SOURCE, "-o", tmp],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{CXX} failed to build {SOURCE} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    c_int, c_i64 = ctypes.c_int, ctypes.c_int64
    sigs = {
        "rle_decode": ([u32p, c_int, u8p, c_i64], None),
        "rle_encode": ([u8p, c_i64, u32p], c_int),
        "rle_area": ([u32p, c_int], ctypes.c_double),
        "rle_iou_matrix": ([u32p, i64p, c_int, u32p, i64p, c_int, u8p, f64p], None),
        "rle_merge": ([u32p, i64p, c_int, c_i64, c_int, u8p], None),
        "bbox_iou_matrix": ([f64p, c_int, f64p, c_int, u8p, f64p], None),
        "cocoeval_match": ([f64p, c_int, c_int, u8p, u8p, f64p, c_int, u8p,
                            i64p, i64p, u8p], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed (raises if it cannot be)."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _LIB = _bind(ctypes.CDLL(build()))
    return _LIB


# ---------------------------------------------------------------------------
# numpy wrappers (the semantics of evaluation/rle.py and coco_eval_core.py)
# ---------------------------------------------------------------------------

def _counts_array(rle: dict) -> np.ndarray:
    # imported here: evaluation/ imports this module while it initialises
    from u2seg_torch.evaluation import rle as rle_codec

    return np.ascontiguousarray(rle_codec._ensure_counts(rle), np.uint32)


def _concat(rles: Sequence[dict]) -> Tuple[np.ndarray, np.ndarray]:
    arrs = [_counts_array(r) for r in rles]
    off = np.zeros(len(arrs) + 1, np.int64)
    np.cumsum([len(a) for a in arrs], out=off[1:])
    flat = np.concatenate(arrs) if arrs else np.zeros(0, np.uint32)
    return np.ascontiguousarray(flat, np.uint32), off


def decode(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    counts = _counts_array(rle)
    out = np.empty(h * w, np.uint8)
    get_lib().rle_decode(counts, len(counts), out, h * w)
    return out.reshape((w, h)).T


def encode(mask: np.ndarray) -> dict:
    from u2seg_torch.evaluation import rle as rle_codec

    h, w = mask.shape
    flat = np.ascontiguousarray(np.asarray(mask).ravel(order="F").astype(np.uint8))
    counts = np.empty(h * w + 1, np.uint32)
    m = get_lib().rle_encode(flat, h * w, counts)
    return {"size": [h, w], "counts": rle_codec.counts_to_string(counts[:m].tolist())}


def area(rle: dict) -> int:
    counts = _counts_array(rle)
    return int(get_lib().rle_area(counts, len(counts)))


def iou(dt: Sequence[dict], gt: Sequence[dict], iscrowd: Sequence[int]) -> np.ndarray:
    d, g = len(dt), len(gt)
    if len(iscrowd) != g:
        raise ValueError(f"{g} gt masks but {len(iscrowd)} crowd flags")
    if d == 0 or g == 0:
        return np.zeros((d, g))
    dt_flat, dt_off = _concat(dt)
    gt_flat, gt_off = _concat(gt)
    out = np.zeros((d, g), np.float64)
    get_lib().rle_iou_matrix(dt_flat, dt_off, d, gt_flat, gt_off, g,
                             np.ascontiguousarray(iscrowd, np.uint8), out)
    return out


def merge(rles: Sequence[dict], intersect: bool = False) -> dict:
    if not rles:
        return {"size": [0, 0], "counts": b""}
    h, w = rles[0]["size"]
    flat, off = _concat(rles)
    out = np.empty(h * w, np.uint8)
    get_lib().rle_merge(flat, off, len(rles), h * w, int(intersect), out)
    return encode(out.reshape((w, h)).T)


def bbox_iou(dt_xywh: np.ndarray, gt_xywh: np.ndarray,
             iscrowd: Sequence[int]) -> np.ndarray:
    d, g = len(dt_xywh), len(gt_xywh)
    if len(iscrowd) != g:
        raise ValueError(f"{g} gt boxes but {len(iscrowd)} crowd flags")
    if d == 0 or g == 0:
        return np.zeros((d, g))
    dt = np.ascontiguousarray(dt_xywh, np.float64).reshape(d, 4)
    gt = np.ascontiguousarray(gt_xywh, np.float64).reshape(g, 4)
    out = np.zeros((d, g), np.float64)
    get_lib().bbox_iou_matrix(dt, d, gt, g, np.ascontiguousarray(iscrowd, np.uint8), out)
    return out


def cocoeval_match(ious: np.ndarray, gt_ignore: np.ndarray, iscrowd: np.ndarray,
                   iou_thrs: np.ndarray, dt_out_of_area: np.ndarray):
    """-> (dtm, gtm, dt_ignore), (T, D), (T, G), (T, D): dtm and gtm hold
    1-based indices of the match (0 = unmatched); an unmatched detection's
    ignore flag is its ``dt_out_of_area``. ``ious`` (D, G) has its gt columns
    sorted with the ignored ones last, its rows score-descending."""
    ious = np.ascontiguousarray(ious, np.float64)
    d, g = ious.shape
    if len(gt_ignore) != g or len(iscrowd) != g or len(dt_out_of_area) != d:
        raise ValueError(f"ious {ious.shape} against {len(gt_ignore)} gt ignore flags, "
                         f"{len(iscrowd)} crowd flags, {len(dt_out_of_area)} dt flags")
    thrs = np.ascontiguousarray(iou_thrs, np.float64)
    t = len(thrs)
    dtm = np.zeros((t, d), np.int64)
    gtm = np.zeros((t, g), np.int64)
    dti = np.zeros((t, d), np.uint8)
    get_lib().cocoeval_match(
        ious, d, g, np.ascontiguousarray(gt_ignore, np.uint8),
        np.ascontiguousarray(iscrowd, np.uint8), thrs, t,
        np.ascontiguousarray(dt_out_of_area, np.uint8), dtm, gtm, dti)
    return dtm, gtm, dti
