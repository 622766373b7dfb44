"""Dataset metadata: the COCO category tables and U2Seg's cluster metadata
(counterpart of ``u2seg_tpu/data/builtin_meta.py``).

Category id conventions:
  - cluster training metadata: ids 1..N are things (N = cluster count),
    ids N+1..N+27 are stuff (27 STEGO classes);
  - evaluation GT stuff supercategories: 15 classes at ids N+1..N+15.
"""
from __future__ import annotations

import colorsys
from typing import Dict, List

# (id, isthing, name, supercategory) for the 133 COCO panoptic categories
# (80 things + 53 stuff), the data behind the reference's giant literal table.
COCO_PANOPTIC_CATEGORIES = [
    (1, 1, "person", "person"), (2, 1, "bicycle", "vehicle"),
    (3, 1, "car", "vehicle"), (4, 1, "motorcycle", "vehicle"),
    (5, 1, "airplane", "vehicle"), (6, 1, "bus", "vehicle"),
    (7, 1, "train", "vehicle"), (8, 1, "truck", "vehicle"),
    (9, 1, "boat", "vehicle"), (10, 1, "traffic light", "outdoor"),
    (11, 1, "fire hydrant", "outdoor"), (13, 1, "stop sign", "outdoor"),
    (14, 1, "parking meter", "outdoor"), (15, 1, "bench", "outdoor"),
    (16, 1, "bird", "animal"), (17, 1, "cat", "animal"),
    (18, 1, "dog", "animal"), (19, 1, "horse", "animal"),
    (20, 1, "sheep", "animal"), (21, 1, "cow", "animal"),
    (22, 1, "elephant", "animal"), (23, 1, "bear", "animal"),
    (24, 1, "zebra", "animal"), (25, 1, "giraffe", "animal"),
    (27, 1, "backpack", "accessory"), (28, 1, "umbrella", "accessory"),
    (31, 1, "handbag", "accessory"), (32, 1, "tie", "accessory"),
    (33, 1, "suitcase", "accessory"), (34, 1, "frisbee", "sports"),
    (35, 1, "skis", "sports"), (36, 1, "snowboard", "sports"),
    (37, 1, "sports ball", "sports"), (38, 1, "kite", "sports"),
    (39, 1, "baseball bat", "sports"), (40, 1, "baseball glove", "sports"),
    (41, 1, "skateboard", "sports"), (42, 1, "surfboard", "sports"),
    (43, 1, "tennis racket", "sports"), (44, 1, "bottle", "kitchen"),
    (46, 1, "wine glass", "kitchen"), (47, 1, "cup", "kitchen"),
    (48, 1, "fork", "kitchen"), (49, 1, "knife", "kitchen"),
    (50, 1, "spoon", "kitchen"), (51, 1, "bowl", "kitchen"),
    (52, 1, "banana", "food"), (53, 1, "apple", "food"),
    (54, 1, "sandwich", "food"), (55, 1, "orange", "food"),
    (56, 1, "broccoli", "food"), (57, 1, "carrot", "food"),
    (58, 1, "hot dog", "food"), (59, 1, "pizza", "food"),
    (60, 1, "donut", "food"), (61, 1, "cake", "food"),
    (62, 1, "chair", "furniture"), (63, 1, "couch", "furniture"),
    (64, 1, "potted plant", "furniture"), (65, 1, "bed", "furniture"),
    (67, 1, "dining table", "furniture"), (70, 1, "toilet", "furniture"),
    (72, 1, "tv", "electronic"), (73, 1, "laptop", "electronic"),
    (74, 1, "mouse", "electronic"), (75, 1, "remote", "electronic"),
    (76, 1, "keyboard", "electronic"), (77, 1, "cell phone", "electronic"),
    (78, 1, "microwave", "appliance"), (79, 1, "oven", "appliance"),
    (80, 1, "toaster", "appliance"), (81, 1, "sink", "appliance"),
    (82, 1, "refrigerator", "appliance"), (84, 1, "book", "indoor"),
    (85, 1, "clock", "indoor"), (86, 1, "vase", "indoor"),
    (87, 1, "scissors", "indoor"), (88, 1, "teddy bear", "indoor"),
    (89, 1, "hair drier", "indoor"), (90, 1, "toothbrush", "indoor"),
    (92, 0, "banner", "textile"), (93, 0, "blanket", "textile"),
    (95, 0, "bridge", "building"), (100, 0, "cardboard", "raw-material"),
    (107, 0, "counter", "furniture-stuff"), (109, 0, "curtain", "textile"),
    (112, 0, "door-stuff", "furniture-stuff"), (118, 0, "floor-wood", "floor"),
    (119, 0, "flower", "plant"), (122, 0, "fruit", "food-stuff"),
    (125, 0, "gravel", "ground"), (128, 0, "house", "building"),
    (130, 0, "light", "furniture-stuff"), (133, 0, "mirror-stuff", "furniture-stuff"),
    (138, 0, "net", "structural"), (141, 0, "pillow", "textile"),
    (144, 0, "platform", "ground"), (145, 0, "playingfield", "ground"),
    (147, 0, "railroad", "ground"), (148, 0, "river", "water"),
    (149, 0, "road", "ground"), (151, 0, "roof", "building"),
    (154, 0, "sand", "ground"), (155, 0, "sea", "water"),
    (156, 0, "shelf", "furniture-stuff"), (159, 0, "snow", "ground"),
    (161, 0, "stairs", "furniture-stuff"), (166, 0, "tent", "building"),
    (168, 0, "towel", "textile"), (171, 0, "wall-brick", "wall"),
    (175, 0, "wall-stone", "wall"), (176, 0, "wall-tile", "wall"),
    (177, 0, "wall-wood", "wall"), (178, 0, "water-other", "water"),
    (180, 0, "window-blind", "window"), (181, 0, "window-other", "window"),
    (184, 0, "tree-merged", "plant"), (185, 0, "fence-merged", "structural"),
    (186, 0, "ceiling-merged", "ceiling"), (187, 0, "sky-other-merged", "sky"),
    (188, 0, "cabinet-merged", "furniture-stuff"), (189, 0, "table-merged", "furniture-stuff"),
    (190, 0, "floor-other-merged", "floor"), (191, 0, "pavement-merged", "ground"),
    (192, 0, "mountain-merged", "solid"), (193, 0, "grass-merged", "plant"),
    (194, 0, "dirt-merged", "ground"), (195, 0, "paper-merged", "raw-material"),
    (196, 0, "food-other-merged", "food-stuff"), (197, 0, "building-other-merged", "building"),
    (198, 0, "rock-merged", "solid"), (199, 0, "wall-other-merged", "wall"),
    (200, 0, "rug-merged", "textile"),
]

#: 53 stuff dataset ids -> 15 supercategory ids (the "map" dict the reference
#: duplicates in three places; SURVEY.md §8 "cluster metadata invariants")
STUFF_TO_SUPERCATEGORY = {
    92: 1, 93: 1, 95: 2, 100: 3, 107: 4, 109: 1, 112: 4, 118: 5, 119: 6,
    122: 7, 125: 8, 128: 2, 130: 4, 133: 4, 138: 9, 141: 1, 144: 8, 145: 8,
    147: 8, 148: 10, 149: 8, 151: 2, 154: 8, 155: 10, 156: 4, 159: 8,
    161: 4, 166: 2, 168: 1, 171: 11, 175: 11, 176: 11, 177: 11, 178: 10,
    180: 12, 181: 12, 184: 6, 185: 9, 186: 13, 187: 14, 188: 4, 189: 4,
    190: 5, 191: 8, 192: 15, 193: 6, 194: 8, 195: 3, 196: 7, 197: 2,
    198: 15, 199: 11, 200: 1,
}

NUM_SUPERCATEGORIES = 15

# COCO person keypoints (public COCO ordering; ref builtin_meta.py
# COCO_PERSON_KEYPOINT_NAMES/FLIP_MAP).
COCO_PERSON_KEYPOINT_NAMES = (
    "nose",
    "left_eye", "right_eye",
    "left_ear", "right_ear",
    "left_shoulder", "right_shoulder",
    "left_elbow", "right_elbow",
    "left_wrist", "right_wrist",
    "left_hip", "right_hip",
    "left_knee", "right_knee",
    "left_ankle", "right_ankle",
)
COCO_PERSON_KEYPOINT_FLIP_MAP = (
    ("left_eye", "right_eye"),
    ("left_ear", "right_ear"),
    ("left_shoulder", "right_shoulder"),
    ("left_elbow", "right_elbow"),
    ("left_wrist", "right_wrist"),
    ("left_hip", "right_hip"),
    ("left_knee", "right_knee"),
    ("left_ankle", "right_ankle"),
)


def create_keypoint_hflip_indices(
    names=COCO_PERSON_KEYPOINT_NAMES,
    flip_map=COCO_PERSON_KEYPOINT_FLIP_MAP,
) -> List[int]:
    """Index permutation applying left/right keypoint identity swaps under
    horizontal flip (ref detection_utils.py:522-544)."""
    fm = dict(flip_map)
    fm.update({v: k for k, v in fm.items()})
    flipped = [fm.get(n, n) for n in names]
    return [list(names).index(n) for n in flipped]


def thing_ids() -> List[int]:
    return [c[0] for c in COCO_PANOPTIC_CATEGORIES if c[1] == 1]


def stuff_ids() -> List[int]:
    return [c[0] for c in COCO_PANOPTIC_CATEGORIES if c[1] == 0]


def thing_dataset_id_to_contiguous_id() -> Dict[int, int]:
    """COCO thing ids (1..90 with gaps) -> 0..79."""
    return {tid: i for i, tid in enumerate(thing_ids())}


def stuff_dataset_id_to_contiguous_id() -> Dict[int, int]:
    """Stuff ids -> 1..53 (0 reserved for 'things'), as in the reference's
    ``transfer`` id_map (sem_seg_evaluation.py:161-201)."""
    return {sid: i + 1 for i, sid in enumerate(stuff_ids())}


def contiguous_stuff_to_supercategory() -> Dict[int, int]:
    """Contiguous stuff label (1..53) -> supercategory id (1..15)."""
    rev = {v: k for k, v in stuff_dataset_id_to_contiguous_id().items()}
    return {cont: STUFF_TO_SUPERCATEGORY[did] for cont, did in rev.items()}


def _color(i: int) -> List[int]:
    """Deterministic distinct color (replaces the reference's random RGB)."""
    h = (i * 0.61803398875) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.65, 0.95)
    return [int(r * 255), int(g * 255), int(b * 255)]


def create_cate(num: int) -> List[dict]:
    """Synthetic cluster categories: ids 1..num things, num+1..num+27 stuff
    (ref builtin_meta.py:17-35; colors deterministic instead of random)."""
    cate = []
    for i in range(num + 27):
        cate.append({
            "supercategory": str(i + 1),
            "id": i + 1,
            "name": str(i + 1),
            "color": _color(i),
            "isthing": 1 if i + 1 <= num else 0,
        })
    return cate


def cluster_metadata(cluster_num: int) -> dict:
    """Full metadata dict for a cluster-trained model (replaces
    MetadataCatalog entries driven by CLUSTER_NUM)."""
    cats = create_cate(cluster_num)
    things = [c for c in cats if c["isthing"] == 1]
    stuffs = [c for c in cats if c["isthing"] == 0]
    return {
        "cluster_num": cluster_num,
        "categories": cats,
        "thing_classes": [c["name"] for c in things],
        "stuff_classes": [c["name"] for c in stuffs],
        "thing_dataset_id_to_contiguous_id": {
            c["id"]: i for i, c in enumerate(things)
        },
        "stuff_dataset_id_to_contiguous_id": {
            c["id"]: i + 1 for i, c in enumerate(stuffs)
        },
    }


def coco_panoptic_metadata() -> dict:
    """Real COCO panoptic metadata (for supervised parity checks)."""
    things = [c for c in COCO_PANOPTIC_CATEGORIES if c[1] == 1]
    stuffs = [c for c in COCO_PANOPTIC_CATEGORIES if c[1] == 0]
    return {
        "thing_classes": [c[2] for c in things],
        "stuff_classes": [c[2] for c in stuffs],
        "thing_dataset_id_to_contiguous_id": thing_dataset_id_to_contiguous_id(),
        "stuff_dataset_id_to_contiguous_id": stuff_dataset_id_to_contiguous_id(),
        "categories": [
            {"id": c[0], "isthing": c[1], "name": c[2], "supercategory": c[3]}
            for c in COCO_PANOPTIC_CATEGORIES
        ],
    }
