"""Visualization of instance, semantic and panoptic predictions without
OpenCV (counterpart of ``u2seg_tpu/utils/visualizer.py``, after
``detectron2/utils/visualizer.py:331`` and ``colormap.py``).

The JAX module draws with ``cv2``; the machine with the card has no OpenCV.
Here the same calls go through ``utils/raster.py``: boxes, keypoint dots and
limbs equal ``cv2`` on every pixel, mask blends are the JAX module's numpy
(with its uint8 truncation), and labels are drawn from a glyph table inside
the box that ``cv2.getTextSize`` gives at the JAX call's origin. Image files
are read and written with Pillow through ``data/image_io.py``.
"""
from __future__ import annotations

import colorsys
from typing import Optional, Sequence

import numpy as np

from u2seg_torch.utils import raster


def colormap(n: int, rgb: bool = True, bright: bool = True) -> np.ndarray:
    """Deterministic distinct colors, shape (n, 3) uint8."""
    out = np.zeros((n, 3), np.uint8)
    for i in range(n):
        h = (i * 0.61803398875) % 1.0
        s = 0.75 if bright else 0.5
        v = 0.95 if bright else 0.7
        r, g, b = colorsys.hsv_to_rgb(h, s, v)
        out[i] = [int(r * 255), int(g * 255), int(b * 255)]
    return out


class Visualizer:
    def __init__(self, img_rgb: np.ndarray, metadata=None, scale: float = 1.0):
        self.img = np.asarray(img_rgb).astype(np.uint8).copy()
        self.metadata = metadata
        self.h, self.w = self.img.shape[:2]
        self._colors = colormap(256)
        # the (x0, y0, x1, y1) box of every label drawn, inclusive
        self.text_boxes = []

    # -- helpers -----------------------------------------------------
    def _class_name(self, cid: int) -> str:
        names = getattr(self.metadata, "thing_classes", None) if self.metadata else None
        if names and 0 <= cid < len(names):
            return str(names[cid])
        return str(cid)

    def _stuff_name(self, cid: int) -> str:
        names = getattr(self.metadata, "stuff_classes", None) if self.metadata else None
        if names and 0 <= cid < len(names):
            return str(names[cid])
        return str(cid)

    def _blend_mask(self, mask: np.ndarray, color: np.ndarray, alpha: float = 0.5):
        m = mask.astype(bool)
        self.img[m] = (
            self.img[m].astype(np.float32) * (1 - alpha)
            + color.astype(np.float32) * alpha
        ).astype(np.uint8)

    def _draw_box(self, box, color):
        x0, y0, x1, y1 = [int(v) for v in box]
        raster.rectangle(self.img, (x0, y0), (x1, y1), np.asarray(color), 2)

    def _draw_text(self, text, pos, color=(255, 255, 255)):
        org = (int(pos[0]), max(int(pos[1]), 10))
        raster.put_text(self.img, text, org, np.asarray(color, np.uint8))
        self.text_boxes.append(raster.text_box(text, org))

    # -- public ------------------------------------------------------
    def draw_instance_predictions(self, instances: dict) -> np.ndarray:
        """instances: {"boxes" (K,4 XYXY), "scores", "classes",
        "masks" optional list of (H,W), "keypoints" optional (K, 17, 3)}."""
        boxes = np.asarray(instances.get("boxes", np.zeros((0, 4))))
        scores = np.asarray(instances.get("scores", np.zeros(len(boxes))))
        classes = np.asarray(
            instances.get("classes", np.zeros(len(boxes), np.int64))
        )
        masks = instances.get("masks")
        keypoints = instances.get("keypoints")
        for i in range(len(boxes)):
            color = self._colors[int(classes[i]) % 256]
            if masks is not None:
                self._blend_mask(np.asarray(masks[i]), color)
            self._draw_box(boxes[i], color)
            if keypoints is not None:
                self.draw_keypoints(np.asarray(keypoints[i]))
            self._draw_text(
                f"{self._class_name(int(classes[i]))} {scores[i]:.0%}",
                (boxes[i][0], boxes[i][1] - 4),
            )
        return self.img

    # COCO person skeleton (public keypoint_connection_rules, ref
    # builtin_meta.py:225 -- index pairs into COCO_PERSON_KEYPOINT_NAMES)
    _SKELETON = (
        (1, 2), (0, 1), (0, 2), (1, 3), (2, 4),       # face
        (5, 7), (7, 9), (6, 8), (8, 10), (5, 6),      # arms + shoulders
        (11, 13), (13, 15), (12, 14), (14, 16), (11, 12),  # legs + hips
        (5, 11), (6, 12),                             # torso
    )

    def draw_keypoints(self, kp: np.ndarray,
                       threshold: float = 0.05) -> np.ndarray:
        """Draw a (K, 3) keypoint set with the COCO person skeleton
        (ref visualizer.py draw_and_connect_keypoints): dots for visible
        points, limb segments where both endpoints are visible."""
        vis = kp[:, 2] > threshold
        for k in range(len(kp)):
            if vis[k]:
                raster.circle_filled(self.img, (int(kp[k, 0]), int(kp[k, 1])),
                                     3, np.array((255, 64, 64), np.uint8))
        if len(kp) == 17:
            for a, b in self._SKELETON:
                if vis[a] and vis[b]:
                    raster.line(self.img,
                                (int(kp[a, 0]), int(kp[a, 1])),
                                (int(kp[b, 0]), int(kp[b, 1])),
                                np.array((64, 255, 64), np.uint8))
        return self.img

    def draw_sem_seg(self, sem_seg: np.ndarray, alpha: float = 0.6) -> np.ndarray:
        sem = np.asarray(sem_seg)
        for label in np.unique(sem):
            if label == 255:
                continue
            self._blend_mask(sem == label, self._colors[int(label) % 256], alpha)
        return self.img

    def draw_panoptic_seg(
        self, panoptic: np.ndarray, segments: Sequence[dict], alpha: float = 0.6
    ) -> np.ndarray:
        pan = np.asarray(panoptic)
        for seg in segments:
            mask = pan == seg["id"]
            if not mask.any():
                continue
            color = self._colors[int(seg["category_id"]) % 256]
            self._blend_mask(mask, color, alpha)
            ys, xs = np.nonzero(mask)
            name = (
                self._class_name(seg["category_id"])
                if seg.get("isthing") else self._stuff_name(seg["category_id"])
            )
            self._draw_text(name, (xs.mean(), ys.mean()))
        return self.img

    def draw_dataset_dict(self, d: dict) -> np.ndarray:
        anns = d.get("annotations", [])
        boxes = []
        classes = []
        for a in anns:
            x, y, w, h = a["bbox"]
            boxes.append([x, y, x + w, y + h])
            classes.append(a["category_id"])
        return self.draw_instance_predictions(
            {"boxes": np.asarray(boxes, np.float64).reshape(-1, 4),
             "scores": np.ones(len(boxes)),
             "classes": np.asarray(classes, np.int64)}
        )


class VideoVisualizer:
    """Tracking-color-consistent video visualization
    (ref video_visualizer.py:41): instance colors follow track ids."""

    def __init__(self, metadata=None):
        self.metadata = metadata
        self._colors = colormap(1024)
        self.text_boxes = []

    def draw_instance_predictions(self, frame_rgb, instances: dict,
                                  track_ids: Optional[np.ndarray] = None):
        vis = Visualizer(frame_rgb, self.metadata)
        boxes = np.asarray(instances.get("boxes", np.zeros((0, 4))))
        classes = np.asarray(instances.get("classes", np.zeros(len(boxes))))
        scores = np.asarray(instances.get("scores", np.ones(len(boxes))))
        masks = instances.get("masks")
        for i in range(len(boxes)):
            key = int(track_ids[i]) if track_ids is not None else int(classes[i])
            color = self._colors[key % 1024]
            if masks is not None:
                vis._blend_mask(np.asarray(masks[i]), color)
            vis._draw_box(boxes[i], color)
            vis._draw_text(
                f"{vis._class_name(int(classes[i]))} {scores[i]:.0%}"
                + (f" #{key}" if track_ids is not None else ""),
                (boxes[i][0], boxes[i][1] - 4),
            )
        self.text_boxes = vis.text_boxes
        return vis.img


def read_image(path: str) -> np.ndarray:
    """An image file as RGB uint8 (Pillow, through ``data/image_io``)."""
    from u2seg_torch.data.image_io import read_image as _read

    return _read(path, "RGB")


def write_image(path: str, image_rgb: np.ndarray) -> None:
    """Write an RGB uint8 image; the format follows the extension (PNG for
    ``.png``, JPEG otherwise), through Pillow (``data/image_io``)."""
    from u2seg_torch.data.image_io import write_jpeg, write_png

    if path.lower().endswith(".png"):
        write_png(path, image_rgb)
    else:
        write_jpeg(path, image_rgb)
