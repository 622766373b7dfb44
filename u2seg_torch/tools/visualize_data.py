"""Draw dataset ground truth or the mapper's augmented training examples
(counterpart of ``tools/visualize_data.py``).

    python -m u2seg_torch.tools.visualize_data [--config-file FILE] [--source annotation|dataloader] \\
        [--dataset NAME] [--output-dir ./vis] [--max-images 20] [key.path=value ...]

"annotation" draws each record of the dataset over its image; "dataloader"
draws the boxes of ``DatasetMapper(cfg, is_train=True)``'s output (augmented,
resized). The datasets are those ``register_all_coco(datasets.root,
datasets.cluster_num)`` registers. A host tool: nothing runs on a device.
Images are read and written with Pillow; the drawing is ``utils.visualizer``.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="u2seg_torch dataset visualization")
    parser.add_argument("--config-file", default="")
    parser.add_argument("--source", choices=["annotation", "dataloader"],
                        default="annotation")
    parser.add_argument("--dataset", default="")
    parser.add_argument("--output-dir", default="./vis")
    parser.add_argument("--max-images", type=int, default=20)
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return parser


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Returns one {"path", "image", "text_boxes"} per image written."""
    import numpy as np

    from u2seg_torch.config import load_config
    from u2seg_torch.data.builtin import register_all_coco
    from u2seg_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from u2seg_torch.data.image_io import read_image
    from u2seg_torch.data.mapper import DatasetMapper
    from u2seg_torch.utils import visualizer as V

    args = get_parser().parse_args(sys.argv[1:] if argv is None else argv)
    cfg = load_config(args.config_file or None, [o for o in args.opts if "=" in o])
    register_all_coco(cfg.datasets.root, cluster_num=cfg.datasets.cluster_num)
    name = args.dataset or cfg.datasets.train[0]
    dicts = DatasetCatalog.get(name)
    meta = MetadataCatalog.get(name)
    os.makedirs(args.output_dir, exist_ok=True)

    written = []

    def write(out, vis):
        V.write_image(out, vis.img)
        written.append({"path": out, "image": vis.img, "text_boxes": vis.text_boxes})
        print("wrote", out)

    if args.source == "annotation":
        for d in dicts[: args.max_images]:
            vis = V.Visualizer(read_image(d["file_name"], "RGB"), meta)
            vis.draw_dataset_dict(d)
            write(os.path.join(args.output_dir, os.path.basename(d["file_name"])), vis)
    else:
        mapper = DatasetMapper(cfg, is_train=True)
        rng = np.random.RandomState(0)
        for i, d in enumerate(dicts[: args.max_images]):
            ex = mapper(d, rng)
            if ex is None:
                continue
            h, w = ex["image_size"]
            img = ex["image"][:h, :w].astype(np.uint8)
            boxes = ex["gt_boxes"][ex["gt_valid"]]
            classes = ex["gt_classes"][ex["gt_valid"]]
            vis = V.Visualizer(img, meta)
            vis.draw_instance_predictions({
                "boxes": boxes, "classes": classes, "scores": np.ones(len(boxes)),
            })
            write(os.path.join(args.output_dir, f"mapped_{i}.jpg"), vis)
    return written


if __name__ == "__main__":
    main()
