"""Operations of ViTDet's attention blocks, counted from shapes, so the
count is the same whatever implements it. Per block, over its T tokens
(windowed blocks count their padded windows, which they compute), in
multiply-adds times 2:

- qkv, 2 * T * dim * 3 dim, and proj, 2 * T * dim * dim;
- with relative positions, the terms ``q R_h`` and ``q R_w``:
  2 * N * (h + w) * d per (image or window, head) over its h x w grid;
- the score product ``q k^T`` and the product with v: 2 * N * N * d each
  per (image or window, head).

The backward is twice the forward (the gradients of both operands). The
softmax, the bias sums, the padding and any recomputation are not
counted."""
from __future__ import annotations

from typing import Sequence, Tuple


def attention_flops(images: int, grid: Tuple[int, int], dim: int, heads: int, depth: int,
                    window: int, global_blocks: Sequence[int],
                    rel_pos: bool = True) -> Tuple[float, float]:
    """(forward, backward) FLOPs of the attention blocks of one training
    step over ``images`` images whose token grid is ``grid``."""
    d = dim // heads
    fwd = 0.0
    gh, gw = grid
    for i in range(depth):
        if i in global_blocks:
            rows, (h, w) = images, grid
        else:
            rows, (h, w) = images * (-(-gh // window)) * (-(-gw // window)), (window, window)
        n = h * w
        fwd += 8.0 * rows * n * dim * dim                     # qkv and proj
        fwd += 4.0 * rows * heads * n * n * d                 # q k^T and with v
        if rel_pos:
            fwd += 2.0 * rows * heads * n * (h + w) * d
    return fwd, 2.0 * fwd
