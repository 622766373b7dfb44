"""The learning-sanity check: train steps on one fixed synthetic batch must
cut the loss (counterpart of the JAX package's ``dev/run_overfit_tpu.py``
and ``tests/engine/test_overfit.py``).

    python -m u2seg_torch.dev.run_overfit [--steps 150] [--lr 0.08] [--device cpu] [--out PATH]

``testing.tiny_spmd_config()`` (R50-FPN at full width, 7 classes, SyncBN,
which is BatchNorm in one process; warmup 2) is trained by
``create_train_state`` / ``make_train_step`` on ``testing.tiny_batch`` of
``RandomState(0)`` (8 images of 64x64), the same batch every step; the
sampling generator of step i is seeded with ``sampling_seed(7, 0, i)``. The
assertions are the JAX script's: every loss finite, the mean of the last 5
total losses below 0.8 x the mean of the first 5, and the last
``loss_rpn_cls`` below 0.5 (the RPN's objectness on fixed data is a pure
binary task). The total cannot fall much further: the batch's random
per-pixel sem-seg labels and random mask patches floor ``loss_sem_seg`` and
``loss_mask``. Runs on ``cuda`` unless ``--device`` names another; prints
the curve, and writes it as JSON where ``--out`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from u2seg_torch.engine.trainer import create_train_state, make_train_step, sampling_seed
from u2seg_torch.testing import tiny_batch, tiny_spmd_config

SAMPLING_SEED = 7


def run_overfit(steps: int = 150, lr: float = 0.08, device=None,
                log: Optional[Callable[[str], None]] = print) -> dict:
    """Train ``steps`` steps at ``lr`` on the fixed batch -> the curve, its
    first-5 / last-5 means, seconds, and ``ok`` (the three assertions)."""
    cfg = tiny_spmd_config()
    cfg.solver.base_lr = lr
    cfg.solver.warmup_iters = 2
    state = create_train_state(cfg, device=device, seed=0)
    dev = next(state.model.parameters()).device
    batch = tiny_batch(np.random.RandomState(0)).to(dev)
    step = make_train_step(state.model, state.optimizer)
    gen = torch.Generator(device=dev)
    losses, rpn_cls = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        gen.manual_seed(sampling_seed(SAMPLING_SEED, 0, i))
        metrics = step(batch, gen)
        losses.append(float(metrics["total_loss"]))
        rpn_cls.append(float(metrics["loss_rpn_cls"]))
        if log is not None:
            log(f"step {i:3d}: total={losses[-1]:.4f} rpn_cls={rpn_cls[-1]:.4f}")
    seconds = time.perf_counter() - t0
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    ok = bool(np.isfinite(losses).all() and np.isfinite(rpn_cls).all()
              and last < first * 0.8 and rpn_cls[-1] < 0.5)
    return {"device": str(dev), "steps": steps, "lr": lr, "total_loss": losses,
            "loss_rpn_cls": rpn_cls, "first5_mean": first, "last5_mean": last,
            "seconds": seconds, "ok": ok}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--lr", type=float, default=0.08)
    ap.add_argument("--device", default=None, help="default: cuda (raises without a GPU)")
    ap.add_argument("--out", help="write the curve and the summary as JSON here")
    args = ap.parse_args(argv)
    res = run_overfit(args.steps, args.lr, args.device)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("total_loss", "loss_rpn_cls")}))
    if not res["ok"]:
        raise SystemExit(f"overfit check failed: total {res['first5_mean']:.3f} -> "
                         f"{res['last5_mean']:.3f}, last loss_rpn_cls "
                         f"{res['loss_rpn_cls'][-1]:.3f}")
    return res


if __name__ == "__main__":
    main()
