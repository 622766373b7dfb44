"""Convert a detectron2 checkpoint into a port checkpoint (counterpart of
``tools/convert_weights.py``).

    python -m u2seg_torch.tools.convert_weights --config-file FILE --input model_final.pkl --output weights.pth

Reads a detectron2 ``.pkl`` or ``.pth`` PanopticFPN checkpoint (the port's
modules carry detectron2's names), loads it into the model that the config
builds (a name the model lacks or a shape that differs is an error) and
writes the loaded tensors as ``{"model": state_dict}`` with ``torch.save``,
ready for ``model.weights``.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--input", required=True, help=".pkl or .pth checkpoint")
    parser.add_argument("--output", required=True, help="output checkpoint file")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                        help="config overrides: key.path=value ...")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)

    import torch

    from u2seg_torch.config import load_config
    from u2seg_torch.engine.checkpoint import load_model_weights
    from u2seg_torch.models.panoptic_fpn import PanopticFPN

    cfg = load_config(args.config_file or None, args.opts)
    model = PanopticFPN(cfg.model)
    info = load_model_weights(model, args.input)
    sd = model.state_dict()
    torch.save({"model": {k: sd[k] for k in info["loaded"]}}, args.output)
    print(f"converted {len(info['loaded'])} tensors from {args.input} "
          f"(the file lacks {len(info['missing'])} of the model's) -> {args.output}")
    return args.output


if __name__ == "__main__":
    main()
