"""One rank of the port's multi-process CPU checks (``tests/test_torch_ddp.py``).

    python tests/torch_dist_worker.py RANK WORLD INIT_URL IN_FILE OUT_DIR

Imports torch and the port only (no JAX). Joins a gloo group through
``u2seg_torch.parallel.launch`` (``INIT_URL`` is a ``file://`` rendezvous),
then runs, in order:

- comm: every helper of ``u2seg_torch.parallel.comm`` beyond one process;
- syncbn: one SyncBN layer in training mode on this rank's rows of a global
  NCHW input, and the gradients of ``sum(y * cotangent)``;
- step: ``make_train_step`` of the config in ``IN_FILE`` from its weights,
  on this rank's share of its global batch, for its number of steps.

``IN_FILE`` is a ``torch.save`` of the inputs (written by the test, so it is
unpickled with ``weights_only=False``); the results go to
``OUT_DIR/rank<RANK>.pt``.
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from u2seg_torch.engine.trainer import (  # noqa: E402
    Batch, create_train_state, make_train_step, sampling_seed,
)
from u2seg_torch.ops.norms import BatchNorm2d  # noqa: E402
from u2seg_torch.parallel import comm  # noqa: E402
from u2seg_torch.parallel.launch import launch  # noqa: E402
from u2seg_torch.parallel.mesh import create_mesh, shard_batch  # noqa: E402
from u2seg_torch.structures.instances import GtInstances  # noqa: E402


def run_comm(out):
    rank = comm.get_rank()
    out["world"], out["rank"] = comm.get_world_size(), rank
    out["is_main"] = comm.is_main_process()
    comm.synchronize()
    # variable-length payloads
    out["all_gather"] = comm.all_gather({"rank": rank, "blob": "x" * (7 + 400 * rank)})
    out["gather"] = comm.gather(rank, dst=0)
    out["reduce_mean"] = comm.reduce_dict({"loss": float(rank + 1)})
    out["reduce_sum"] = comm.reduce_dict({"n": float(rank + 1)}, average=False)
    out["seed"] = comm.shared_random_seed()
    a = torch.full((2, 3), float(rank + 1))
    b = torch.arange(4, dtype=torch.float32) * (rank + 1)
    comm.all_reduce_mean_([a, b])
    out["mean_a"], out["mean_b"] = a, b
    c = torch.full((3,), float(rank))
    d = torch.full((2,), rank, dtype=torch.int64)
    comm.broadcast_([c, d], src=1)
    out["broadcast"] = (c, d)


def run_syncbn(inp, out, mesh):
    x, ct = inp["x"], inp["ct"]
    n = x.shape[0] // mesh.world_size
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    bn = BatchNorm2d(x.shape[1], sync=True).train()
    with torch.no_grad():
        bn.weight.copy_(inp["weight"])
        bn.bias.copy_(inp["bias"])
    xr = x[rows].clone().requires_grad_()
    y = bn(xr)
    (y * ct[rows]).sum().backward()
    out["syncbn"] = dict(y=y.detach(), gx=xr.grad, gw=bn.weight.grad, gb=bn.bias.grad,
                         mean=bn.running_mean.clone(), var=bn.running_var.clone())


def run_step(inp, out, mesh):
    b = inp["batch"]
    batch = Batch(torch.from_numpy(b["images"]), torch.from_numpy(b["image_sizes"]),
                  GtInstances(torch.from_numpy(b["boxes"]), torch.from_numpy(b["classes"]),
                              torch.from_numpy(b["valid"]), torch.from_numpy(b["masks"])),
                  torch.from_numpy(b["sem_seg"]))
    state = create_train_state(inp["cfg"], device="cpu", seed=0)
    state.model.load_state_dict(inp["state"])
    comm.broadcast_(list(state.model.state_dict().values()), src=0)
    step = make_train_step(state.model, state.optimizer, mesh)
    local = shard_batch(mesh, batch)
    gen = torch.Generator()
    rows = []
    for i in range(inp["steps"]):
        gen.manual_seed(sampling_seed(1, mesh.rank, i))
        metrics = step(local, gen)
        rows.append(dict(
            metrics={k: float(v) for k, v in metrics.items()},
            stats={k: v.clone() for k, v in state.model.state_dict().items()
                   if "running_" in k}))
    out["step"] = dict(rows=rows, final=state.model.state_dict(),
                       momentum=[state.optimizer.state[p]["momentum_buffer"]
                                 for p in state.model.parameters()],
                       count=state.step)


def main(rank, world, in_file, out_dir):
    inp = torch.load(in_file, weights_only=False)
    mesh = create_mesh("cpu")
    out = {}
    run_comm(out)
    run_syncbn(inp["syncbn"], out, mesh)
    run_step(inp["step"], out, mesh)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    torch.set_num_threads(1)
    rank, world, init, in_file, out_dir = sys.argv[1:6]
    launch(main, backend="gloo", init_method=init, world_size=int(world),
           rank=int(rank), args=(int(rank), int(world), in_file, out_dir))
