"""A training loop written out, without a trainer or hooks (counterpart of
``tools/plain_train_net.py``): the train loader of ``train_net``, the
train step, the LR schedule, the metric writers and the checkpoints, in
plain code to copy and change.

    python -m u2seg_torch.tools.plain_train_net --config-file FILE [--device cpu] [--resume] [--max-iter N] [key.path=value ...]
"""
from __future__ import annotations

import logging
import os
import sys
from typing import List, Optional

import torch

logger = logging.getLogger("plain_train_net")


def do_train(cfg, device: str = "cuda", max_iter: Optional[int] = None,
             resume: bool = False):
    """Train on ``cfg.datasets.train`` and return the ``TrainState``: resume
    from ``output_dir`` (``resume``), else start from ``model.weights``
    when set; write metrics every 20 iterations and at the end, checkpoints
    every ``checkpoint_period`` and at the end."""
    from u2seg_torch.engine.checkpoint import Checkpointer, load_model_weights
    from u2seg_torch.engine.events import CommonMetricPrinter, EventStorage, JSONWriter
    from u2seg_torch.engine.train_loop import batch_from_numpy
    from u2seg_torch.engine.trainer import create_train_state, make_train_step, sampling_seed
    from u2seg_torch.parallel import comm
    from u2seg_torch.parallel.mesh import create_mesh
    from u2seg_torch.solver import build_lr_schedule
    from u2seg_torch.tools.train_net import build_train_loader

    mesh = create_mesh(device)
    loader = iter(build_train_loader(cfg))
    seed = max(cfg.seed, 0)
    state = create_train_state(cfg, device=mesh.device, seed=seed)
    comm.broadcast_(list(state.model.state_dict().values()), src=0)
    step = make_train_step(state.model, state.optimizer, mesh)
    schedule = build_lr_schedule(cfg.solver)
    ckptr = Checkpointer(cfg.output_dir)
    start_iter = 0
    if resume and ckptr.has_checkpoint():
        restored = ckptr.load(ckptr.get_checkpoint_file(), map_location=mesh.device)
        state.model.load_state_dict(restored["model"])
        state.optimizer.load_state_dict(restored["optimizer"])
        start_iter = int(restored["iteration"]) + 1
    elif cfg.model.weights:
        load_model_weights(state.model, cfg.model.weights)

    max_iter = max_iter or cfg.solver.max_iter
    writers = [CommonMetricPrinter(max_iter),
               JSONWriter(os.path.join(cfg.output_dir, "metrics.json"))] \
        if comm.is_main_process() else []
    generator = torch.Generator(device=mesh.device)
    with EventStorage(start_iter) as storage:
        for iteration in range(start_iter, max_iter):
            storage.iter = iteration
            batch = batch_from_numpy(next(loader)).to(mesh.device)
            generator.manual_seed(sampling_seed(seed + 1, mesh.rank, state.step))
            metrics = step(batch, generator)
            values = torch.stack([v.float() for v in metrics.values()]).tolist()
            storage.put_scalars(**dict(zip(metrics, values)))
            storage.put_scalar("lr", float(schedule(iteration)), smoothing_hint=False)
            last = iteration == max_iter - 1
            if (iteration + 1) % 20 == 0 or last:
                for w in writers:
                    w.write(storage)
            if (iteration + 1) % cfg.solver.checkpoint_period == 0 or last:
                ckptr.save(f"model_{iteration:07d}", {
                    "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(), "iteration": iteration})
    return state


def main(argv: Optional[List[str]] = None):
    from u2seg_torch.tools.train_net import default_argument_parser, setup

    args = default_argument_parser().parse_args(sys.argv[1:] if argv is None else argv)
    cfg = setup(args)
    return do_train(cfg, device=args.device, max_iter=args.max_iter or None,
                    resume=args.resume)


if __name__ == "__main__":
    main()
