"""Convert ADE20k annotations to training PNGs (counterpart of
``tools/prepare_ade20k_sem_seg.py``; detectron2's
``datasets/prepare_ade20k_sem_seg.py``).

    python -m u2seg_torch.tools.prepare_ade20k_sem_seg [--root datasets/ADEChallengeData2016]

Every file of ``annotations/{training,validation}`` becomes a file of the
same name under ``annotations_detectron2/``: label 0 (unlabeled) -> 255,
classes 1..150 -> 0..149. A host tool: files are read and written with
Pillow through ``data.image_io``; nothing runs on a device.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from u2seg_torch.data.image_io import read_sem_seg, write_png


def convert(label: np.ndarray) -> np.ndarray:
    """ADE20k labels -> contiguous training ids with 255 ignored."""
    lab = label.astype(np.int16)
    return np.where(lab == 0, 255, lab - 1).astype(np.uint8)


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Returns the paths written."""
    p = argparse.ArgumentParser(description="ADE20k sem-seg PNGs for training")
    p.add_argument("--root", default="datasets/ADEChallengeData2016")
    args = p.parse_args(argv)
    written = []
    for split in ("training", "validation"):
        src = os.path.join(args.root, "annotations", split)
        dst = os.path.join(args.root, "annotations_detectron2", split)
        os.makedirs(dst, exist_ok=True)
        for f in sorted(os.listdir(src)):
            out = os.path.join(dst, f)
            write_png(out, convert(read_sem_seg(os.path.join(src, f))))
            written.append(out)
            print("wrote", out)
    return written


if __name__ == "__main__":
    main()
