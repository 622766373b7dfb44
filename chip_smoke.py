"""Smoke run of the u2seg_torch port on one CUDA card.

    python3 chip_smoke.py [--report PATH]

Phases (each prints one or more lines; any failure raises and exits non-zero):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: the port's CUDA kernels compiled from ``u2seg_torch/csrc`` (nvcc,
   sm_90a), one nvcc per source, all started together;
3. kernel vs plain: the multilevel ROIAlign kernel against its plain PyTorch
   twin on the card, at main-path shapes (p2-p5 of an 800x1216 image, C=256;
   R=1000 at s=7, R=100 at s=14), f32 with TF32 off at 1e-4 and bf16 at the
   AMP tolerance (rtol 0.05, atol 0.03); its time, the twin's, and the bound;
4. the slice: the default Config() at full width (R50-FPN, 3-stage cascade
   over 800 classes, masks, 28 sem-seg classes, bf16) with seeded weights
   serves 4 requests (3 at 800x1216, 1 at 512x832, b=1); the kernel's launch
   count must grow by 4 per forward; then torch.profiler over warm forwards
   of each shape (device busy share, top kernels). Before it,
   ``u2seg_torch.entry.entry()`` (the flagship forward at 512x832) runs once;
5. card vs CPU: the same forward at 512x832 in f32 (TF32 off) with
   pooler_impl="pallas" on both devices (the CPU runs the kernel's twin).

The last lines are the kernels' JSON record, the nvidia-smi line, and
``{"ok": true, "device": {...}}``. With no CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 flop/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Calibration of the random cls_score heads, as bench.py does it: scale each
# stage's cls_score weight and bias by TAU so the 801-way softmax is neither
# saturated (TAU=1: every stage one-hot on another class, averaged scores
# stuck at 1/3) nor flat. bench.py's TAU=0.12 was tuned on the JAX package's
# init; the port's seeded init draws other numbers, and at 0.12 no averaged
# score reaches the 0.05 test threshold. The port's own value is 0.3; phase
# 4 prints the score spread at both values.
BENCH_CLS_WEIGHT_TAU = 0.12
CLS_WEIGHT_TAU = 0.3
AMP_RTOL, AMP_ATOL = 0.05, 0.03
F32_TOL = 1e-4


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ---------------------------------------------------------------------------
# Phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------

def boundary_boxes(h: int, w: int) -> torch.Tensor:
    """Boxes that stress each routing branch; the budget-edge cases sit at
    the top real level (stride 32: SPAN_BUDGET=28 cells = 896 px)."""
    return torch.tensor([
        [10.0, 20.0, 122.0, 132.0],        # sqrt-area exactly 112
        [30.0, 5.0, 254.0, 229.0],         # exactly 224
        [0.0, 0.0, 448.0, 448.0],          # exactly 448
        [5.0, 10.0, 345.0, 30.0],          # long side -> window-fit bump
        [40.0, 2.0, 60.0, 220.0],          # tall thin -> bump
        [16.0, 20.0, 912.0, 916.0],        # exactly at budget on p5
        [5.0, 3.0, 955.0, 953.0],          # over budget on p5 -> virtual level
        [0.0, 0.0, 2000.0, 1900.0],        # over budget on the virtual level
        [50.0, 50.0, 50.0, 50.0],          # zero size
        [0.0, 0.0, 0.0, 0.0],              # zero box
        [w - 160.0, h - 110.0, w + 40.0, h + 20.0],   # past the image corner
        [12.5, 7.25, 44.75, 39.5],         # small, fractional
    ])


def random_proposals(rng, n: int, h: int, w: int) -> torch.Tensor:
    cx, cy = rng.rand(n) * w, rng.rand(n) * h
    bw = np.exp(rng.uniform(np.log(8), np.log(800), n))
    bh = bw * np.exp(rng.uniform(-1.2, 1.2, n))
    b = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)
    b[:, 0::2] = b[:, 0::2].clip(0, w)
    b[:, 1::2] = b[:, 1::2].clip(0, h)
    return torch.from_numpy(b.astype(np.float32))


def work_of(rap, feats, boxes, bidx, s, strides, in_bytes, out_bytes):
    """Bytes (touched level cells read once, output written once, ROI inputs)
    and flops (2 per nonzero tap weight pair, per channel) this run needs."""
    ext, st = rap._append_virtual_level(feats, strides)
    dims = tuple((f.shape[1], f.shape[2]) for f in ext)
    wy, wx, idx, prep, _ = rap._ml_geometry(boxes, bidx, dims, st, s, 2, 224.0, 4)
    c = feats[0].shape[-1]
    touched = (wy != 0).any(1)[:, :, None] & (wx != 0).any(1)[:, None, :]
    cells = torch.unique(idx[touched]).numel()
    r_n = boxes.shape[0]
    nbytes = cells * c * in_bytes + r_n * s * s * c * out_bytes + r_n * 20
    ny = (wy != 0).sum(-1).reshape(r_n, s, 2).sum(-1).float()
    nx = (wx != 0).sum(-1).reshape(r_n, s, 2).sum(-1).float()
    flops = float((ny[:, :, None] * nx[:, None, :]).sum()) * 2 * c
    return nbytes, flops


def phase_kernel(dev):
    from u2seg_torch.ops import roi_align_ml as rap

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h, w, c = 800, 1216, 256
    strides = (4, 8, 16, 32)
    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.RandomState(0)
    base = [torch.randn(1, h // st, w // st, c, generator=g, device=dev)
            for st in strides]
    results = {}
    for s, n in ((7, 1000), (14, 100)):
        edge = boundary_boxes(h, w)
        boxes = torch.cat([edge, random_proposals(rng, n - len(edge), h, w)]).to(dev)
        bidx = torch.zeros(n, dtype=torch.int32, device=dev)
        rec = {"s": s, "R": n}
        for dtype in (torch.float32, torch.bfloat16):
            feats = [f.to(dtype) for f in base]
            got = rap.multilevel_roi_align_kernel(feats, boxes, bidx, s, strides,
                                                  out_dtype=dtype)
            ref = rap.multilevel_roi_align_ref(feats, boxes, bidx, s, strides)
            torch.cuda.synchronize()
            err = (got.float() - ref).abs()
            scale = float(ref.abs().max())
            name = "f32" if dtype == torch.float32 else "bf16"
            rec[f"max_abs_err_{name}"] = float(err.max())
            rec[f"ref_max_{name}"] = scale
            rec[f"edge_err_{name}"] = float(err[:len(edge)].max())
            if dtype == torch.float32:
                ok = bool((err <= F32_TOL * max(scale, 1.0)).all())
                tol = f"{F32_TOL:g} * max(1, max|ref|)"
            else:
                ok = bool((err <= AMP_ATOL + AMP_RTOL * ref.abs()).all())
                tol = f"atol {AMP_ATOL} + rtol {AMP_RTOL}"
            log(f"[kernel] s={s} R={n} {name}: max|kernel-plain|={rec[f'max_abs_err_{name}']:.3e} "
                f"(budget-edge boxes {rec[f'edge_err_{name}']:.3e}, max|plain|={scale:.3f}, "
                f"tol {tol}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernel disagrees with its plain version ({name}, s={s})")
        # timing at the main path's dtype (bf16 levels -> bf16 pooled)
        feats = [f.to(torch.bfloat16) for f in base]
        args = rap.prepare_launch(feats, boxes, bidx, s, 2, strides, 224.0, 4,
                                  torch.bfloat16)
        rec["ms"] = cuda_ms(lambda: rap.launch(args), iters=50)
        rec["wrapper_ms"] = cuda_ms(lambda: rap.multilevel_roi_align_kernel(
            feats, boxes, bidx, s, strides, out_dtype=torch.bfloat16), iters=20)
        rec["plain_ms"] = cuda_ms(lambda: rap.multilevel_roi_align_ref(
            feats, boxes, bidx, s, strides), iters=3, warmup=1)
        nbytes, flops = work_of(rap, feats, boxes, bidx, s, strides, 2, 2)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
        rec.update(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"[kernel] s={s} R={n} bf16 timing: kernel {rec['ms']:.4f} ms, "
            f"wrapper (prep+kernel) {rec['wrapper_ms']:.4f} ms, plain {rec['plain_ms']:.3f} ms, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP); library call: none (no single PyTorch op "
            f"computes this pooler; torchvision is not installed)")
        results[s] = rec
    return results


# ---------------------------------------------------------------------------
# Phase 4 / 5: the slice
# ---------------------------------------------------------------------------

def scene(rng, h: int, w: int) -> np.ndarray:
    """A numpy-drawn RGB scene: smooth background + 10-25 solid ellipses."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for ch in range(3):
        a, b_, c_ = rng.rand(3)
        img[..., ch] = 60 + 80 * (a * yy / h + b_ * xx / w + c_) / 3
    for _ in range(rng.randint(10, 25)):
        cy, cx = rng.rand() * h, rng.rand() * w
        ay, ax = rng.randint(18, 90), rng.randint(18, 90)
        th = rng.rand() * np.pi
        dy, dx = yy - cy, xx - cx
        u = (dx * np.cos(th) + dy * np.sin(th)) / ax
        v = (-dx * np.sin(th) + dy * np.cos(th)) / ay
        img[u * u + v * v <= 1.0] = rng.rand(3) * 255
    return img.clip(0, 255)


def calibrate(model, tau: float = CLS_WEIGHT_TAU):
    with torch.no_grad():
        for m in model.roi_heads.box_predictor:
            m.cls_score.weight.mul_(tau)
            m.cls_score.bias.mul_(tau)
    return model


def score_spread(model, img, sz, tau: float) -> str:
    """Quantiles of each proposal's best averaged class score, and how many
    (proposal, class) pairs pass the test threshold, at calibration ``tau``."""
    sd = {k: v.clone() for k, v in model.roi_heads.state_dict().items()}
    with torch.no_grad():
        for m in model.roi_heads.box_predictor:
            m.cls_score.weight.mul_(tau / CLS_WEIGHT_TAU)
            m.cls_score.bias.mul_(tau / CLS_WEIGHT_TAU)
        f = model.features(img)
        props = model.proposal_generator(f, sz).proposal_boxes
        _, probs = model.roi_heads.forward_box(f, props, sz)
    model.roi_heads.load_state_dict(sd)
    best = probs[..., :-1].amax(-1).float().flatten()
    q = best.quantile(torch.tensor([0.05, 0.5, 0.95], device=best.device)).tolist()
    above = int((probs[..., :-1] > model.cfg.roi_heads.score_thresh_test).sum())
    return (f"TAU={tau}: best averaged class score q05/q50/q95 "
            f"{q[0]:.4f}/{q[1]:.4f}/{q[2]:.4f}, pairs above "
            f"{model.cfg.roi_heads.score_thresh_test} {above}")


def phase_entry():
    from u2seg_torch.entry import entry

    forward, args = entry()
    boxes, scores, panoptic = forward(*args)
    torch.cuda.synchronize()
    ok = (boxes.shape == (1, 100, 4) and scores.shape == (1, 100)
          and panoptic.shape == (1, 128, 208) and bool(torch.isfinite(boxes).all()))
    log(f"[slice] entry(): boxes {tuple(boxes.shape)}, scores {tuple(scores.shape)}, "
        f"panoptic {tuple(panoptic.shape)} on {boxes.device} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("entry() returned unexpected outputs")


def phase_slice(dev):
    from u2seg_torch.config import Config
    from u2seg_torch.models.build import build_model
    from u2seg_torch.ops.roi_align_ml import multilevel_roi_align_kernel as k

    phase_entry()
    cfg = Config()
    model = calibrate(build_model(cfg, device=dev, seed=0))
    rng = np.random.RandomState(1)
    shapes = [(800, 1216)] * 3 + [(512, 832)]
    reqs = []
    for h, w in shapes:
        img = torch.from_numpy(scene(rng, h, w))[None].to(dev)
        reqs.append((img, torch.tensor([[h, w]], dtype=torch.int32, device=dev)))
    for h, w in sorted(set(shapes)):                      # warm-up per shape
        img, sz = next(r for r in reqs if r[0].shape[1:3] == (h, w))
        model(img, sz, combine=True)
    for tau in (BENCH_CLS_WEIGHT_TAU, CLS_WEIGHT_TAU):
        log(f"[slice] calibration on request 0, {score_spread(model, *reqs[0], tau)}")
    torch.cuda.synchronize()

    k.launches = 0                                        # the main path starts
    rows = []
    for i, (img, sz) in enumerate(reqs):
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(img, sz, combine=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        det = out.detections
        n_det = int(det.valid.sum())
        n_seg = int(out.seg_valid.sum())
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        h, w = img.shape[1:3]
        finite = all(bool(torch.isfinite(t).all()) for t in
                     (det.boxes, det.scores, det.mask_logits, out.sem_seg_logits))
        shapes_ok = (out.panoptic.shape == (1, h // 4, w // 4)
                     and out.sem_seg_logits.shape == (1, h // 4, w // 4, 28)
                     and det.boxes.shape == (1, 100, 4))
        log(f"[slice] request {i}: {h}x{w} latency {ms:.2f} ms, valid detections "
            f"{n_det}, fused segments {n_seg} "
            f"({int((out.seg_valid & out.seg_is_thing).sum())} things), "
            f"peak memory {peak:.0f} MiB")
        if not (finite and shapes_ok and n_det > 0):
            raise AssertionError(f"request {i}: finite={finite} shapes={shapes_ok} "
                                 f"detections={n_det}")
        rows.append(dict(h=h, w=w, ms=ms, detections=n_det, segments=n_seg,
                         peak_mib=peak))
    launches = k.launches                                 # the main path ends
    log(f"[slice] roi_align_ml launches: {launches} over {len(reqs)} forwards")
    if launches != 4 * len(reqs):
        raise AssertionError(f"expected {4 * len(reqs)} kernel launches, got {launches}")
    return rows, launches, model, reqs


def phase_profile(model, req, iters: int = 3):
    """torch.profiler over ``iters`` warm forwards of one request: wall time,
    summed device-kernel time (-> the device's busy share) and the kernels
    that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    img, sz = req
    model(img, sz, combine=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            model(img, sz, combine=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    h, w = img.shape[1:3]
    log(f"[profile] {h}x{w} forward: wall {wall_ms:.2f} ms, device kernels "
        f"{dev_ms:.2f} ms -> busy {dev_ms / wall_ms:.3f}, idle {1 - dev_ms / wall_ms:.3f}; "
        f"{sum(e.count for e in kernels) / iters:.0f} kernel launches per forward")
    rows = []
    for e in top:
        ms = e.self_device_time_total / 1e3 / iters
        rows.append(dict(name=e.key[:90], ms=ms, count=e.count / iters))
        log(f"[profile]   {ms:8.3f} ms  x{e.count / iters:5.0f}  {e.key[:90]}")
    return dict(h=h, w=w, wall_ms=wall_ms, device_ms=dev_ms, top=rows)


def phase_cpu_parity(dev):
    from u2seg_torch.config import Config
    from u2seg_torch.models.build import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config()
    cfg.model.compute_dtype = "float32"
    cfg.model.roi_heads.pooler_impl = "pallas"
    # every detection eligible for fusion, so instance painting is compared
    cfg.model.panoptic.instance_conf_thresh = cfg.model.roi_heads.score_thresh_test
    gpu = calibrate(build_model(cfg, device=dev, seed=0))
    cpu = calibrate(build_model(cfg, device="cpu", seed=0))
    h, w = 512, 832
    img = torch.from_numpy(scene(np.random.RandomState(2), h, w))[None]
    sz = torch.tensor([[h, w]], dtype=torch.int32)
    res = {}
    with torch.no_grad():
        fc, fg = cpu.features(img), gpu.features(img.to(dev))
        sc, sg = cpu.sem_seg_head(fc), gpu.sem_seg_head(fg).cpu()
        res["sem_err"] = float((sc - sg).abs().max() / sc.abs().max())
        pc = cpu.proposal_generator(fc, sz)
        pg = gpu.proposal_generator(fg, sz.to(dev))
        same = (pc.proposal_valid == pg.proposal_valid.cpu()).all(-1)
        box_err = (pc.proposal_boxes - pg.proposal_boxes.cpu()).abs().amax(-1)
        res["proposal_agree"] = float(((box_err < 1e-2) & pc.proposal_valid).sum()
                                      / pc.proposal_valid.sum())
        # cascade stages on the SAME (CPU) proposals on both devices
        _, prob_c = cpu.roi_heads.forward_box(fc, pc.proposal_boxes, sz)
        _, prob_g = gpu.roi_heads.forward_box(fg, pc.proposal_boxes.to(dev), sz.to(dev))
        res["cascade_score_err"] = float((prob_c - prob_g.cpu()).abs().max())
        oc = cpu(img, sz, combine=True)
        og = gpu(img.to(dev), sz.to(dev), combine=True)
    dc, dg = oc.detections, og.detections
    match = ((dc.classes == dg.classes.cpu()) & dc.valid & dg.valid.cpu()
             & ((dc.boxes - dg.boxes.cpu()).abs().amax(-1) < 0.5))
    res["det_agree"] = float(match.sum() / max(int(dc.valid.sum()), 1))
    res["detections"] = int(dc.valid.sum())
    res["things"] = int((oc.seg_valid & oc.seg_is_thing).sum())
    res["pan_agree"] = float((oc.panoptic == og.panoptic.cpu()).float().mean())
    log(f"[cpu] 512x832 f32 pooler=pallas: sem logits max|gpu-cpu|/max|cpu| "
        f"{res['sem_err']:.2e} (tol 1e-3); proposals equal (all valid flags "
        f"{bool(same.all())}, box diff < 0.01 px) {res['proposal_agree']:.4f} "
        f"(tol >= 0.95); averaged cascade scores on the same proposals "
        f"max|gpu-cpu| {res['cascade_score_err']:.2e} (tol 1e-4); final "
        f"detections agreeing (class, box < 0.5 px) {res['det_agree']:.4f} of "
        f"{res['detections']}; panoptic pixels agreeing {res['pan_agree']:.4f} "
        f"({res['things']} things painted on the CPU)")
    if not (res["sem_err"] <= 1e-3 and res["proposal_agree"] >= 0.95
            and res["cascade_score_err"] <= 1e-4):
        raise AssertionError(f"card and CPU disagree: {res}")
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", help="also write every number as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from u2seg_torch import _cuda

    dev = torch.device("cuda", 0)
    smi = smi_line()
    log(f"[device] {smi} | {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda} | count "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    paths = _cuda.build(["roi_align_ml"])
    build_s = time.perf_counter() - t0
    log(f"[build] {len(paths)} kernel library built in {build_s:.1f} s")
    for name, p in paths.items():
        if os.path.exists(p + ".log"):
            with open(p + ".log") as f:
                for line in f:
                    if "registers" in line or "Compiling entry" in line:
                        log(f"[build] {name}: {line.strip()}")

    kern = phase_kernel(dev)
    rows, launches, model, reqs = phase_slice(dev)
    prof = [phase_profile(model, reqs[0]), phase_profile(model, reqs[-1])]
    del model
    parity = phase_cpu_parity(dev)

    main_rec = kern[7]
    record = {"kernels": [{
        "name": "roi_align_ml",
        "route": "cuda",
        "source": "u2seg_torch/csrc/roi_align_ml.cu",
        "replaces": "u2seg_tpu/ops/roi_align_pallas.py:435",
        "launches": launches,
        "max_abs_err": max(kern[s]["max_abs_err_f32"] for s in kern),
        "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": None,
    }]}
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump({"smi": smi, "build_s": build_s, "kernel": kern,
                       "slice": rows, "launches": launches, "profile": prof,
                       "cpu_parity": parity,
                       "record": record}, f, indent=1)
    log(json.dumps(record))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
