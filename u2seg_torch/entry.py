"""Entry points: the flagship inference forward on one device, and a
data-parallel dry run over several processes.

Counterparts of ``entry()`` and ``dryrun_multichip(n)`` in the repository's
``__graft_entry__.py``. ``entry`` builds the default ``Config()`` (R50-FPN,
3-stage cascade over 800 classes, masks, 28 sem-seg classes, bf16 compute),
one 512x832 image, weights from the port's seeded init; it runs on ``cuda``
unless ``device`` says otherwise, and with no GPU and no explicit device it
raises. ``dryrun_multichip(n)`` runs one data-parallel train step of the tiny
config over ``n`` gloo processes on the CPU (the JAX dry run likewise runs
on a CPU mesh):

    python -m u2seg_torch.entry multichip N
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from u2seg_torch.config import Config
from u2seg_torch.models.build import build_model


def entry(device=None):
    """-> (forward, (images, sizes)); ``forward(images, sizes)`` returns
    (detection boxes, detection scores, stride-4 panoptic id map)."""
    cfg = Config()
    h, w, b = 512, 832, 1
    model = build_model(cfg, device=device)
    dev = next(model.parameters()).device
    images = torch.zeros((b, h, w, 3), dtype=torch.float32, device=dev)
    sizes = torch.tensor([[h, w]] * b, dtype=torch.int32, device=dev)

    def forward(images, sizes):
        out = model(images, sizes, combine=True)
        return out.detections.boxes, out.detections.scores, out.panoptic

    return forward, (images, sizes)


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> str:
    """One data-parallel train step of ``testing.tiny_spmd_config()`` on
    ``testing.tiny_batch(RandomState(0), b=n_devices)`` over ``n_devices``
    gloo processes on the CPU. Each process checks that one update was made
    and every metric is finite; rank 0 prints the metrics, and its output is
    printed and returned. Raises if any process fails, after printing its
    output."""
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "u2seg_torch.entry", "multichip-rank",
             str(n_devices), str(rank), init],
            cwd=_ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(n_devices)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        for r in failed:
            sys.stdout.write(f"--- rank {r} (exit {procs[r].returncode}) ---\n{outs[r]}")
        raise RuntimeError(f"dryrun_multichip({n_devices}): ranks {failed} failed")
    sys.stdout.write(outs[0])
    return outs[0]


def _dryrun_rank(n_devices: int) -> None:
    from u2seg_torch.engine.trainer import (
        create_train_state, make_train_step, sampling_seed,
    )
    from u2seg_torch.parallel import comm
    from u2seg_torch.parallel.mesh import create_mesh, shard_batch
    from u2seg_torch.testing import tiny_batch, tiny_spmd_config

    mesh = create_mesh("cpu")
    assert mesh.world_size == n_devices, (mesh.world_size, n_devices)
    cfg = tiny_spmd_config()
    state = create_train_state(cfg, device="cpu", seed=0)
    comm.broadcast_(list(state.model.state_dict().values()), src=0)
    step = make_train_step(state.model, state.optimizer, mesh)
    batch = shard_batch(mesh, tiny_batch(np.random.RandomState(0), b=n_devices))
    gen = torch.Generator().manual_seed(sampling_seed(1, mesh.rank, 0))
    metrics = {k: float(v) for k, v in step(batch, gen).items()}
    assert state.step == 1, state.step
    for k, v in metrics.items():
        assert np.isfinite(v), f"{k} not finite"
    if mesh.rank == 0:
        print(f"dryrun_multichip({n_devices}): ok -",
              {k: round(v, 4) for k, v in metrics.items()}, flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["multichip"]:
        dryrun_multichip(int(sys.argv[2]))
    elif sys.argv[1:2] == ["multichip-rank"]:
        from u2seg_torch.parallel.launch import launch

        torch.set_num_threads(1)
        n, rank, init = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
        launch(_dryrun_rank, backend="gloo", init_method=init, world_size=n,
               rank=rank, args=(n,))
    else:
        sys.exit("usage: python -m u2seg_torch.entry multichip N")
