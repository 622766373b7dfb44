"""Learning sanity on the CPU: the port's train step cuts the loss on one
fixed batch (counterpart of ``tests/engine/test_overfit.py``; the card runs
the JAX script's protocol, 150 steps at lr 0.08, in ``chip_smoke.py`` phase
``overfit``).

The JAX test's config and protocol: ``tiny_spmd_config()``, lr 0.02, warmup
2, 20 steps on ``tiny_batch(RandomState(0))``; every loss finite, the mean
of the last 5 total losses below 0.8 x the first 5. Its third assertion,
the last ``loss_rpn_cls`` below 0.5, fails on the JAX package itself at
this protocol (0.681 after 20 steps on the CPU; the port gives 0.686): the
RPN's objectness needs the script's 150 steps at lr 0.08 to get there (the
JAX package's record ``artifacts/overfit_tpu.json``: 0.655 after 20 steps,
0.26 after 150). Here the RPN's objectness must fall below its first
step's; the 0.5 bound is held on the card at the script's protocol.

Marked slow: ~2 minutes on 8 CPU threads (the JAX test is slow-marked too).
"""
import numpy as np
import pytest

from u2seg_torch.dev.run_overfit import run_overfit


@pytest.mark.slow
def test_loss_decreases_on_fixed_batch():
    res = run_overfit(steps=20, lr=0.02, device="cpu", log=None)
    losses, rpn_cls = res["total_loss"], res["loss_rpn_cls"]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert np.isfinite(losses).all() and np.isfinite(rpn_cls).all()
    assert last < first * 0.8, f"loss did not decrease: {first:.3f} -> {last:.3f}"
    assert rpn_cls[-1] < rpn_cls[0], f"rpn objectness did not improve: {rpn_cls}"
