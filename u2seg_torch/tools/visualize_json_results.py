"""Draw COCO-format prediction files over their images (counterpart of
``tools/visualize_json_results.py``).

    python -m u2seg_torch.tools.visualize_json_results --input PRED.json --dataset-json GT.json \\
        --image-root DIR [--output ./vis_results] [--conf-threshold 0.5] [--max-images 50]

Predictions at or above the threshold are grouped by image; boxes, scores,
categories and RLE masks are drawn with ``utils.visualizer``. The JSON is
read with the port's COCO API and the masks with its RLE codec. A host tool:
nothing runs on a device. Images are read and written with Pillow.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict
from typing import List, Optional


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="u2seg_torch prediction visualization")
    parser.add_argument("--input", required=True, help="prediction json")
    parser.add_argument("--dataset-json", required=True, help="GT coco json")
    parser.add_argument("--image-root", required=True)
    parser.add_argument("--output", default="./vis_results")
    parser.add_argument("--conf-threshold", type=float, default=0.5)
    parser.add_argument("--max-images", type=int, default=50)
    return parser


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Returns one {"path", "image", "text_boxes"} per image written."""
    import numpy as np

    from u2seg_torch.data.image_io import read_image
    from u2seg_torch.evaluation import rle as rle_codec
    from u2seg_torch.evaluation.coco_api import COCO
    from u2seg_torch.utils import visualizer as V

    args = get_parser().parse_args(sys.argv[1:] if argv is None else argv)
    with open(args.input) as f:
        predictions = json.load(f)
    coco = COCO(args.dataset_json)
    by_image = defaultdict(list)
    for p in predictions:
        if p["score"] >= args.conf_threshold:
            by_image[p["image_id"]].append(p)

    os.makedirs(args.output, exist_ok=True)
    written = []
    for i, (img_id, preds) in enumerate(sorted(by_image.items())):
        if i >= args.max_images:
            break
        info = coco.imgs[img_id]
        img = read_image(os.path.join(args.image_root, info["file_name"]), "RGB")
        boxes, scores, classes, masks = [], [], [], []
        for p in preds:
            x, y, w, h = p["bbox"]
            boxes.append([x, y, x + w, y + h])
            scores.append(p["score"])
            classes.append(p["category_id"])
            if "segmentation" in p:
                masks.append(rle_codec.decode(p["segmentation"]))
        inst = {
            "boxes": np.asarray(boxes, np.float64).reshape(-1, 4),
            "scores": np.asarray(scores),
            "classes": np.asarray(classes, np.int64),
        }
        if masks:
            inst["masks"] = masks
        vis = V.Visualizer(img)
        vis.draw_instance_predictions(inst)
        out = os.path.join(args.output, info["file_name"].replace("/", "_"))
        V.write_image(out, vis.img)
        written.append({"path": out, "image": vis.img, "text_boxes": vis.text_boxes})
        print("wrote", out)
    return written


if __name__ == "__main__":
    main()
