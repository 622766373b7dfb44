"""Times K3, the multilevel ROIAlign backward, and variants of its source on the card.

    python3 -m u2seg_torch.dev.time_roi_align_backward [--variant NAME=VALUE ...] [--report PATH]

A variant is a copy of ``csrc/roi_align_ml.cu`` with ``constexpr int``
settings of the backward given other values (``kSegment=8``,
``kStages=4,kRingBytes=73728``, ...) and the gather's blocks per SM in its
launch bounds (``blocks=4``), or another
whole source with the same C interface (``source=PATH``: an earlier design
step kept outside the tracked files), built beside the shipped library; a
variant named ``diag:...`` is a diagnostic build that skips part of the work
(its gradients are wrong by design and not checked), to see where the time
goes;
while it runs, the wrapper's mirrors of those values (``SEGMENT``,
``STAGES``, ``RING_BYTES``) follow it. At the ``k3`` phase's
shapes of ``chip_smoke.py`` (b=2 at 800x1344, p2-p5 + the virtual level,
C=256, bf16 levels, f32 cotangent; R=1024 proposals at s=7, R=256 at s=14)
and on a pile of 200 large ROIs over one region (s=7: lists of up to ~100
ROIs on p5 and the virtual level), each build's whole call and each of its
launches alone are timed as device time (``graph_ms``: 10 calls in one CUDA
graph), in turns: shipped, variants, shipped. Each variant's gradients are
held against the shipped build's at 1e-4 * max|grad| (another segment length
adds in another order).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re

import numpy as np
import torch

from u2seg_torch import _cuda
from u2seg_torch.dev.sweep_forward_plan import graph_ms, proposals, smi_line
from u2seg_torch.ops import roi_align_ml as rap

STRIDES = (4, 8, 16, 32)
MIRRORS = {"kSegment": "SEGMENT", "kStages": "STAGES", "kRingBytes": "RING_BYTES"}
FNS = (rap._route_fn, rap._lists_fn, rap._plan_fn, rap._backward_fn, rap._fold_fn)


def variant_source(settings) -> str:
    """Writes the variant's source (the shipped one with each (name, value)
    of ``settings`` applied) under the build directory; its path."""
    with open(_cuda.source_path("roi_align_ml")) as f:
        src = f.read()
    for name, value in settings:
        if name == "blocks":
            pattern, repl = r"__launch_bounds__\(kGatherThreads, \d+\)", \
                f"__launch_bounds__(kGatherThreads, {value})"
        else:
            pattern, repl = rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};"
        src, n = re.subn(pattern, repl, src)
        if n != 1:
            raise ValueError(f"{name} is not one setting of the source")
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    tag = "_".join(f"{n}{v}" for n, v in settings)
    path = os.path.join(_cuda.BUILD_DIR, f"roi_align_ml_{tag}.cu")
    with open(path, "w") as f:
        f.write(src)
    return path


@contextlib.contextmanager
def build_of(variant):
    """The wrapper on the shipped library (variant None) or on a variant's,
    with its mirrors set to match."""
    saved = {m: getattr(rap, m) for m in MIRRORS.values()}
    lib = _cuda._LIBS.get("roi_align_ml")
    try:
        if variant is not None:
            settings = [tuple(v.split("=", 1)) for v in variant.removeprefix("diag:").split(",")]
            if settings[0][0] == "source":
                src = settings[0][1]
            else:
                src = variant_source(settings)
            path = next(iter(_cuda.build([os.path.abspath(src)]).values()))
            _cuda._LIBS["roi_align_ml"] = ctypes.CDLL(path)
            for name, value in settings:
                if name in MIRRORS:
                    setattr(rap, MIRRORS[name], int(value))
        for fn in FNS:
            fn.cache_clear()
        yield
    finally:
        for m, v in saved.items():
            setattr(rap, m, v)
        if lib is not None:
            _cuda._LIBS["roi_align_ml"] = lib
        for fn in FNS:
            fn.cache_clear()


def pile_boxes(rng, n: int = 200) -> torch.Tensor:
    """n large ROIs (500-1800 px) over one region of an 800x1344 image: at
    n=200 the p5 and virtual-level tiles there are met by more than 4
    segments' worth of ROIs each (up to ~80 and ~115)."""
    cxy = np.array([600.0, 400.0]) + rng.uniform(-24, 24, (n, 2))
    size = np.exp(rng.uniform(np.log(500), np.log(1800), n))
    wh = np.stack([size, size * np.exp(rng.uniform(-0.3, 0.3, n))], 1)
    return torch.from_numpy(np.concatenate([cxy - wh / 2, cxy + wh / 2], 1).astype(np.float32))


def cases(dev):
    """(name, s, extended levels' shapes, cotangent, roi_i, roi_f)."""
    (h, w), c = (800, 1344), 256
    gen = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.RandomState(3)
    feats = [torch.randn(2, h // st, w // st, c, generator=gen, device=dev).to(torch.bfloat16)
             for st in STRIDES]
    pile = pile_boxes(rng)
    out = []
    for name, s, boxes in (("proposals", 7, proposals(rng, 1024, h, w)),
                           ("proposals", 14, proposals(rng, 256, h, w)), ("pile", 7, pile)):
        boxes = boxes.to(dev)
        bidx = torch.from_numpy(rng.randint(0, 2, len(boxes)).astype(np.int32)).to(dev)
        if name == "pile":
            bidx.zero_()
        ext, st_ext = rap._append_virtual_level(feats, STRIDES)
        fa = rap._prepare_ext(ext, boxes, bidx, s, 2, st_ext, 224.0, 4, torch.float32)
        g = torch.randn(len(boxes), s, s, c, generator=gen, device=dev)
        out.append((f"{name} s={s} R={len(boxes)}", s, [tuple(f.shape) for f in ext], g,
                    fa.roi_i, fa.roi_f))
    return out


def gather_report(variant) -> str:
    """What the compiler said of the gather kernel of a build: registers and
    spills (nvcc's -Xptxas=-v report beside the library)."""
    if variant is None:
        src = _cuda.source_path("roi_align_ml")
    else:
        settings = [tuple(v.split("=", 1)) for v in variant.removeprefix("diag:").split(",")]
        src = settings[0][1] if settings[0][0] == "source" else variant_source(settings)
    with open(_cuda.library_path(os.path.abspath(src)) + ".log") as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "roi_align_ml_backward_kernel" in line:
            return " ".join(l.split("info    :")[-1].strip() for l in lines[i + 1:i + 3])
    return "no report"


def time_build(case, variant):
    """Whole call and launches alone (device ms), and the gradients."""
    _, s, shapes, g, roi_i, roi_f = case
    with build_of(variant):
        ba = rap.prepare_backward(g, roi_i, roi_f, shapes, s, 2)
        whole = graph_ms([lambda: rap.multilevel_roi_align_backward(ba)], iters=10)
        grads = [t.clone() for t in rap.multilevel_roi_align_backward(ba)]
        steps = rap.backward_steps(ba)
        alone = {name: graph_ms([step], iters=10) for name, step in steps}
    return dict(ms=whole, steps=alone), grads


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE...]: constexprs of the backward and "
                         "blocks=N, or source=PATH")
    ap.add_argument("--report", help="also write the readings as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    variants = [None] + args.variant + [None]
    print(f"[k3 variants] {smi_line()}", flush=True)
    _cuda.load("roi_align_ml")
    rows = []
    for case in cases(dev):
        base = None
        for variant in variants:
            try:
                rec, grads = time_build(case, variant)
            except RuntimeError as e:                 # a variant that does not build
                print(f"[k3 variants] {case[0]} {variant}: {str(e)[:400]}", flush=True)
                continue
            label = "shipped" if variant is None else variant
            if base is None:
                base = grads
            err = max(float((a - b).abs().max()) for a, b in zip(grads, base))
            scale = max(float(b.abs().max()) for b in base)
            ok = err <= 1e-4 * max(1.0, scale) or label.startswith("diag:")
            rows.append(dict(case=case[0], build=label, err=err, ok=ok, **rec))
            print(f"[k3 variants] {case[0]} {label}: whole call {rec['ms']:.4f} ms; alone "
                  + ", ".join(f"{k} {v:.4f}" for k, v in rec["steps"].items())
                  + f"; max|grad - shipped| {err:.2e} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{label} disagrees with the shipped build on {case[0]}")
    for variant in variants[:-1]:
        print(f"[k3 variants] gather kernel of {variant or 'shipped'}: {gather_report(variant)}",
              flush=True)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
