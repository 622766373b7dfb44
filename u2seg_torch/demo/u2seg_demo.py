"""Panoptic segmentation demo on images, a video or a webcam (counterpart of
``demo/u2seg_demo.py``, after the reference's setup_cfg :23, the
--hungarian_matching flag :48 and its predict + visualize loop :102-140).

    python -m u2seg_torch.demo.u2seg_demo --config-file configs/COCO-PanopticSegmentation/u2seg_R50_800.yaml \\
        --input img1.jpg img2.jpg --output out_dir [--hungarian-matching-dir DIR] \\
        [--confidence-threshold 0.5] [--device cpu] [key.path=value ...]

Images are read and written with Pillow (``data/image_io``); the drawing is
``utils.visualizer`` (no OpenCV). ``--confidence-threshold`` sets the
instance score threshold of the ROI heads (``model.roi_heads.score_thresh_test``)
and of the panoptic fusion (``model.panoptic.instance_conf_thresh``), as the
reference's setup_cfg does; the JAX package's demo parses the flag and never
reads it. ``--video-input`` and ``--webcam`` decode and encode frames with
OpenCV's VideoCapture / VideoWriter, looked up when the option is used: the
port does not depend on OpenCV (the machine with the card has none), and
without it these options raise an error that names it.
"""
from __future__ import annotations

import argparse
import glob
import importlib
import importlib.util
import os
import sys
import time
from typing import Iterator, List, Optional

import numpy as np

# the optional host video decoder of --video-input / --webcam
VIDEO_MODULE = "cv2"


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="u2seg_torch demo")
    parser.add_argument(
        "--config-file",
        default="configs/COCO-PanopticSegmentation/u2seg_R50_800.yaml",
    )
    parser.add_argument("--input", nargs="+", help="input images (globs ok)")
    parser.add_argument("--video-input", help="video file")
    parser.add_argument("--webcam", action="store_true")
    parser.add_argument("--output", help="output dir or file")
    parser.add_argument(
        "--confidence-threshold", type=float, default=0.5,
        help="instance score threshold of the ROI heads and the panoptic fusion",
    )
    parser.add_argument(
        "--hungarian-matching-dir", default="",
        help="dir with instance/semantic mapping jsons: remap cluster ids "
             "to real categories before visualization",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return parser


def setup_cfg(args):
    """The config of ``--config-file`` and the overrides, with the
    confidence threshold applied (reference demo setup_cfg :23)."""
    from u2seg_torch.config import load_config

    cfg = load_config(args.config_file or None, [o for o in args.opts if "=" in o])
    cfg.model.roi_heads.score_thresh_test = args.confidence_threshold
    cfg.model.panoptic.instance_conf_thresh = args.confidence_threshold
    return cfg


def video_module():
    """OpenCV, for video files and webcams; raises where it is not
    installed."""
    if importlib.util.find_spec(VIDEO_MODULE) is None:
        raise ImportError(
            f"--video-input and --webcam decode and encode frames with OpenCV "
            f"({VIDEO_MODULE}.VideoCapture / VideoWriter), which is not installed; "
            f"pass images with --input instead")
    return importlib.import_module(VIDEO_MODULE)


def _frames(cam) -> Iterator[np.ndarray]:
    while cam.isOpened():
        ok, frame = cam.read()
        if not ok:
            break
        yield np.ascontiguousarray(frame[:, :, ::-1])     # BGR -> RGB


def main(argv: Optional[List[str]] = None):
    from u2seg_torch.demo.predictor import VisualizationDemo
    from u2seg_torch.utils.visualizer import read_image, write_image

    args = get_parser().parse_args(sys.argv[1:] if argv is None else argv)
    cfg = setup_cfg(args)
    demo = VisualizationDemo(cfg, args.hungarian_matching_dir, device=args.device)

    if args.input:
        paths = []
        for pat in args.input:
            paths.extend(sorted(glob.glob(pat)) or [pat])
        if args.output:
            os.makedirs(args.output, exist_ok=True)
        results = []
        for path in paths:
            img = read_image(path)
            t0 = time.perf_counter()
            predictions, vis = demo.run_on_image(img)
            n_inst = len(predictions["instances"]["scores"])
            print(f"{path}: {n_inst} instances in {time.perf_counter() - t0:.2f}s")
            if args.output:
                write_image(os.path.join(args.output, os.path.basename(path)), vis)
            results.append((path, predictions, vis))
        return results
    if args.video_input or args.webcam:
        cv2 = video_module()
        cam = cv2.VideoCapture(0 if args.webcam else args.video_input)
        writer = None
        try:
            for _, _, vis in demo.run_on_video(_frames(cam)):
                if args.output:
                    if writer is None:
                        h, w = vis.shape[:2]
                        writer = cv2.VideoWriter(
                            args.output, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (w, h))
                    writer.write(np.ascontiguousarray(vis[:, :, ::-1]))
        finally:
            cam.release()
            if writer is not None:
                writer.release()
    return None


if __name__ == "__main__":
    main()
