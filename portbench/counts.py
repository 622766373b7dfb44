"""Operations and bytes of the work, counted from shapes or on the
benchmark's own reference model, so a count is the same whatever implements
the work; and the card's published peaks.

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W power limit.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

PEAK_BF16_FLOPS = 989e12        # FLOP/s, bf16 dense tensor cores
PEAK_TF32_FLOPS = 494.7e12      # FLOP/s, tf32 dense tensor cores (f32 convolutions)
# the peak of the products of a configuration's compute dtype
PEAK_FLOPS = {"bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_TF32_FLOPS}
PEAK_HBM_BYTES = 3.35e12        # bytes/s

K3_ROI_RECORD_BYTES = 32        # one ROI's input record (box, batch index)


def virtual_level_hw(h: int, w: int) -> Tuple[int, int]:
    """The pooler kernels' virtual level: a 2x average pool of the top level,
    odd sides edge-padded."""
    return (h + 1) // 2, (w + 1) // 2


def k3_bytes(level_hw: Sequence[Tuple[int, int]], batch: int, channels: int,
             rois: int, s: int) -> int:
    """The least bytes one K3 call (the pooler's backward) moves: the f32
    gradient of every level, the virtual level included, written once, the
    f32 cotangent (R, s, s, C) read once, and each ROI's record."""
    levels = list(level_hw) + [virtual_level_hw(*level_hw[-1])]
    cells = sum(h * w for h, w in levels)
    return 4 * batch * cells * channels + 4 * rois * s * s * channels + \
        K3_ROI_RECORD_BYTES * rois


def roofline_share(least_seconds: float, seconds: float) -> float:
    """The share, in percent, of the least time the work needs in the time it
    took."""
    return 100.0 * least_seconds / seconds


def counted_flops(fn: Callable[[], None], skip: str = "pooler") -> float:
    """FLOPs of the matrix products and convolutions that ``fn`` runs
    (``torch.utils.flop_counter``), less those counted inside modules whose
    name ends in ``skip``: the reference's pooler interpolates with einsums,
    which are not the model's products."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    counts = counter.get_flop_counts()
    total = sum(counts.get("Global", {}).values())
    skipped = sum(sum(ops.values()) for mod, ops in counts.items()
                  if mod.endswith(skip))
    return float(total - skipped)


def train_step_flops(model, batch, generator) -> float:
    """FLOPs of one training step of the reference ``model`` (forward and
    backward) on ``batch``."""
    def step():
        model.zero_grad(set_to_none=True)
        losses = model(batch.images, batch.image_sizes, gt=batch.gt,
                       sem_seg_gt=batch.sem_seg, train=True, generator=generator)
        sum(losses.values()).backward()

    flops = counted_flops(step)
    model.zero_grad(set_to_none=True)
    return flops
