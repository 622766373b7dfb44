"""Training and evaluation from the command line (counterpart of
``tools/train_net.py``).

    python -m u2seg_torch.tools.train_net --config-file configs/COCO-PanopticSegmentation/u2seg_R50_800.yaml \\
        [--device cpu] [--num-devices N] [--resume] [--max-iter N] [key.path=value ...]
    python -m u2seg_torch.tools.train_net --config-file ... --eval-only \\
        --eval-mode auto model.weights=output/u2seg_800/model_0269999

Training reads the datasets of ``datasets.train`` from files (registered by
``register_all_coco(datasets.root, datasets.cluster_num)``), maps them with
``DatasetMapper`` and batches them with ``build_detection_train_loader``;
``DefaultTrainer`` trains with its default hooks, resumes from
``output_dir`` with ``--resume``, and otherwise starts from
``model.weights`` when it is set. ``--eval-only`` scores ``datasets.test``
with ``run_panoptic_evaluation`` on ``model.weights``. Everything runs on
``--device`` (``cuda`` by default). ``--num-devices N`` starts N processes,
one rank each (gloo on the CPU, NCCL on the cards); each rank maps its own
share of the sampler's stream, ``solver.ims_per_batch / N`` images a step.
"""
from __future__ import annotations

import argparse
import logging
import os
import subprocess
import sys
import tempfile
from typing import List, Optional

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def default_argument_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="u2seg_torch training")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument(
        "--eval-mode", default="eval",
        choices=["hungarian_matching", "eval", "auto", "supervised"],
        help="U2Seg two-pass cluster matching mode ('auto' = single pass)")
    parser.add_argument("--num-devices", type=int, default=0,
                        help="processes (ranks) to train with (0 or 1 = this process)")
    parser.add_argument("--max-iter", type=int, default=0,
                        help="override solver.max_iter (0 = config value)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--dist-url", default=None, help=argparse.SUPPRESS)
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                        help="config overrides: key.path=value ...")
    return parser


def setup(args):
    """Config from the file and the overrides; ``output_dir`` made, logging
    set up, the config saved there (by rank 0)."""
    from u2seg_torch.config import load_config, save_config
    from u2seg_torch.parallel import comm

    cfg = load_config(args.config_file or None, args.opts)
    os.makedirs(cfg.output_dir, exist_ok=True)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s %(name)s]: %(message)s",
                        datefmt="%m/%d %H:%M:%S")
    if comm.is_main_process():
        save_config(cfg, os.path.join(cfg.output_dir, "config.yaml"))
    return cfg


def build_train_loader(cfg):
    """This rank's train loader: the datasets of ``cfg.datasets.train``,
    images with only crowd annotations dropped (if configured), the sampler
    of ``cfg.dataloader.sampler`` sharded by rank, ``ims_per_batch / world``
    images a batch."""
    from u2seg_torch.data.builtin import register_all_coco
    from u2seg_torch.data.catalog import DatasetCatalog
    from u2seg_torch.data.loader import (
        RepeatFactorTrainingSampler, build_detection_train_loader,
        filter_images_with_only_crowd_annotations,
    )
    from u2seg_torch.data.mapper import DatasetMapper
    from u2seg_torch.parallel import comm

    register_all_coco(cfg.datasets.root, cluster_num=cfg.datasets.cluster_num)
    dicts = []
    for name in cfg.datasets.train:
        dicts.extend(DatasetCatalog.get(name))
    if cfg.dataloader.filter_empty_annotations:
        dicts = filter_images_with_only_crowd_annotations(dicts)
    seed, rank, world = max(cfg.seed, 0), comm.get_rank(), comm.get_world_size()
    sampler = None
    if cfg.dataloader.sampler == "RepeatFactorTrainingSampler":
        sampler = RepeatFactorTrainingSampler(dicts, cfg.dataloader.repeat_threshold,
                                              seed=seed, rank=rank, world_size=world)
    elif cfg.dataloader.sampler != "TrainingSampler":
        raise ValueError(f"unknown dataloader.sampler {cfg.dataloader.sampler!r}")
    if cfg.solver.ims_per_batch % world:
        raise ValueError(f"solver.ims_per_batch {cfg.solver.ims_per_batch} does not "
                         f"split over {world} ranks")
    n = cfg.solver.ims_per_batch // world
    return build_detection_train_loader(
        dicts, DatasetMapper(cfg, is_train=True), total_batch_size=n, seed=seed,
        rank=rank, world_size=world, sampler=sampler,
        num_workers=cfg.dataloader.num_workers, prefetch=cfg.dataloader.prefetch)


def do_eval(cfg, args) -> dict:
    """``run_panoptic_evaluation`` of ``cfg.datasets.test`` on the model of
    ``cfg.model.weights``; cluster mappings go to ``output_dir``."""
    from u2seg_torch.engine.predictor import run_panoptic_evaluation

    return run_panoptic_evaluation(
        cfg, eval_mode=args.eval_mode, device=args.device,
        matching_dir=os.path.join(cfg.output_dir, "hungarian_matching"))


def _main(args):
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    cfg = setup(args)
    if args.eval_only:
        results = do_eval(cfg, args)
        print(results, flush=True)
        return results

    from u2seg_torch.engine.train_loop import DefaultTrainer
    from u2seg_torch.engine.trainer import check_trainable

    check_trainable(cfg)                        # before the data is read
    trainer = DefaultTrainer(cfg, build_train_loader(cfg), device=args.device,
                             sharded_loader=True)
    trainer.register_hooks(trainer.build_hooks())
    trainer.resume_or_load(resume=args.resume)
    trainer.train(args.max_iter or None)
    return trainer


def _launch_ranks(argv: List[str], n: int) -> None:
    """Run this command as ``n`` processes, rank r of n each, with a
    ``file://`` rendezvous; raises if any fails."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory() as tmp:
        url = "file://" + os.path.join(tmp, "rendezvous")
        # the rank flags go first: the overrides take the rest of the line
        procs = [subprocess.Popen([sys.executable, "-m", "u2seg_torch.tools.train_net",
                                   "--rank", str(r), "--dist-url", url, *argv], env=env)
                 for r in range(n)]
        try:
            codes = [p.wait() for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if any(codes):
        raise RuntimeError(f"train_net: ranks exited with {codes}")


def main(argv: Optional[List[str]] = None):
    """Parse ``argv`` (default: the command line) and train or evaluate;
    returns the trainer, or the metrics of ``--eval-only`` (None from the
    parent of ``--num-devices N > 1``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = default_argument_parser().parse_args(argv)
    if args.num_devices > 1 and args.rank is None:
        _launch_ranks(argv, args.num_devices)
        return None
    if args.rank is None:
        return _main(args)
    from u2seg_torch.parallel.launch import launch

    backend = "gloo" if args.device == "cpu" else "nccl"
    return launch(_main, backend=backend, init_method=args.dist_url,
                  world_size=args.num_devices, rank=args.rank, args=(args,))


if __name__ == "__main__":
    main()
