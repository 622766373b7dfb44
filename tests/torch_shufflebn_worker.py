"""One rank of the ShuffleBN check (``tests/test_torch_projects.py``).

    python tests/torch_shufflebn_worker.py RANK WORLD INIT_URL OUT_DIR

Imports torch and the port only (no JAX). Joins a gloo group (``INIT_URL``
is a ``file://`` rendezvous), draws this rank's rows of a global NCHW batch
from ``inputs(rank)``, and saves to ``OUT_DIR/rank<RANK>.pt``: the rows
back from ``batch_unshuffle(batch_shuffle(x))``, the permutation,
``shuffled_bn`` of a BN layer in training mode, and the gradient of
``sum(y * cotangent)`` with respect to the rows.
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from u2seg_torch.ops.norms import BatchNorm2d  # noqa: E402
from u2seg_torch.parallel.launch import launch  # noqa: E402
from u2seg_torch.projects import rethinking_bn as R  # noqa: E402

ROWS, CHANNELS, SIDE, SEED = 3, 4, 5, 7


def inputs(rank: int):
    g = torch.Generator().manual_seed(100 + rank)
    x = torch.randn(ROWS, CHANNELS, SIDE, SIDE, generator=g) * (1 + rank)
    return x, torch.randn(ROWS, CHANNELS, SIDE, SIDE, generator=g)


def main(rank: int, out_dir: str):
    x, cot = inputs(rank)
    back, perm = R.batch_shuffle(x, torch.Generator().manual_seed(SEED))
    back = R.batch_unshuffle(back, perm)
    bn = BatchNorm2d(CHANNELS).train()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, CHANNELS))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, CHANNELS))
    xg = x.clone().requires_grad_()
    y = R.shuffled_bn(bn, xg, torch.Generator().manual_seed(SEED))
    (y * cot).sum().backward()
    torch.save(dict(back=back, perm=perm, y=y.detach(), grad=xg.grad,
                    running_mean=bn.running_mean.clone()),
               os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    rank, world, init, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    launch(main, backend="gloo", init_method=init, world_size=world, rank=rank,
           args=(rank, out_dir))
