"""Training driven by python-file LazyConfigs (counterpart of
``tools/lazyconfig_train_net.py``, after the reference's do_train :44).

    python -m u2seg_torch.tools.lazyconfig_train_net --config-file CFG.py [--device cpu] [--resume] [--eval-only] [a.b=value ...]

The config file is a python module whose module-level names define the
experiment: ``base`` (a ``LazyCall`` node that builds the ``Config``; the
default ``Config()`` when absent) and ``train`` (``max_iter``,
``output_dir``). Example::

    from u2seg_torch.config import Config
    from u2seg_torch.lazy import LazyCall

    base = LazyCall(Config)()
    train = dict(max_iter=100, output_dir="./output/lazy")

Training runs through ``plain_train_net.do_train`` on ``--device`` (``cuda``
by default). ``--eval-only`` scores ``datasets.test`` with
``run_panoptic_evaluation`` on ``model.weights`` instead (the JAX tool parses
the flag and trains all the same).
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="u2seg_torch LazyConfig training")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return parser


def main(argv: Optional[List[str]] = None):
    from u2seg_torch.config import Config
    from u2seg_torch.lazy import LazyConfig, instantiate

    args = get_parser().parse_args(sys.argv[1:] if argv is None else argv)
    cfg = LazyConfig.load(args.config_file)
    LazyConfig.apply_overrides(cfg, [o for o in args.opts if "=" in o])
    base = instantiate(cfg.get("base"))
    if base is None:
        base = Config()
    train_opts = cfg.get("train", {})
    if "output_dir" in train_opts:
        base.output_dir = train_opts["output_dir"]
    if args.eval_only:
        from u2seg_torch.engine.predictor import run_panoptic_evaluation

        return run_panoptic_evaluation(base, device=args.device)

    from u2seg_torch.tools.plain_train_net import do_train

    return do_train(base, device=args.device, max_iter=train_opts.get("max_iter"),
                    resume=args.resume)


if __name__ == "__main__":
    main()
