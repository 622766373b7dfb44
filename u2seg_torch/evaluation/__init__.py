"""Part of the u2seg_torch port; see the package docstring."""
from u2seg_torch.evaluation.coco_api import COCO
from u2seg_torch.evaluation.coco_eval_core import COCOeval
from u2seg_torch.evaluation.coco_evaluator import COCOEvaluator
from u2seg_torch.evaluation.evaluator import (
    DatasetEvaluator,
    DatasetEvaluators,
    inference_on_dataset,
)
from u2seg_torch.evaluation.panoptic_evaluator import COCOPanopticEvaluator
from u2seg_torch.evaluation.rotated_coco_evaluator import (
    RotatedCOCOeval,
    RotatedCOCOEvaluator,
)
from u2seg_torch.evaluation.sem_seg_evaluator import SemSegEvaluator

__all__ = [
    "COCO", "COCOeval", "COCOEvaluator", "COCOPanopticEvaluator",
    "DatasetEvaluator", "DatasetEvaluators", "RotatedCOCOeval",
    "RotatedCOCOEvaluator", "SemSegEvaluator", "inference_on_dataset",
]
