"""Parameter counts, forward FLOPs and bytes of a model (counterpart of
``tools/analyze_model.py``).

    python -m u2seg_torch.tools.analyze_model [--config-file FILE] [--height 800] [--width 1344] [--device cpu] [key.path=value ...]

Prints the lines of the JAX tool: total parameters, a table per module at
depth 2, forward GFLOPs and GB. The model is built from the config with its
seeded weights (the counts do not depend on them) and run once on a zero
image of the given size on ``--device`` (``cuda`` by default). FLOPs come
from ``torch.utils.flop_counter`` (convs, GEMMs and the K1 op's formula);
bytes from ``utils.analysis.BytesAccessedMode``, the sum of every aten op's
operand and result bytes, which is this package's counterpart of XLA's
"bytes accessed".
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="u2seg_torch model analysis")
    parser.add_argument("--config-file", default="")
    parser.add_argument("--height", type=int, default=800)
    parser.add_argument("--width", type=int, default=1344)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return parser


def main(argv: Optional[List[str]] = None) -> dict:
    import torch

    from u2seg_torch.config import load_config
    from u2seg_torch.models.build import build_model
    from u2seg_torch.utils.analysis import (
        flop_count, parameter_count, parameter_count_by_module,
    )

    args = get_parser().parse_args(sys.argv[1:] if argv is None else argv)
    t0 = time.perf_counter()
    cfg = load_config(args.config_file or None, [o for o in args.opts if "=" in o])
    model = build_model(cfg, device=args.device)
    dev = next(model.parameters()).device
    h, w = args.height, args.width
    images = torch.zeros((1, h, w, 3), dtype=torch.float32, device=dev)
    sizes = torch.tensor([[h, w]], dtype=torch.int32, device=dev)

    total = parameter_count(model)
    print(f"Total parameters: {total / 1e6:.2f}M")
    rows = parameter_count_by_module(model, depth=2)
    for name, n in rows.items():
        print(f"  {name:40s} {n / 1e6:8.2f}M")
    cost = flop_count(lambda im, sz: model(im, sz, combine=True), images, sizes)
    print(f"Forward FLOPs (torch.utils.flop_counter): {cost['flops'] / 1e9:.2f} GFLOPs")
    print(f"Bytes accessed (sum of every aten op's operands and results, the "
          f"counterpart of XLA's 'bytes accessed'): {cost['bytes_accessed'] / 1e9:.2f} GB")
    return dict(parameters=total, modules=rows, flops=cost["flops"],
                bytes_accessed=cost["bytes_accessed"], flops_by_op=cost["flops_by_op"],
                seconds=time.perf_counter() - t0)


if __name__ == "__main__":
    main()
