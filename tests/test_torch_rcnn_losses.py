"""The training forward of u2seg_torch's Mask + Keypoint R-CNN (Standard ROI
heads, a 2-conv GN box head), ProposalNetwork and SemanticSegmentor vs the
JAX package on the CPU: loss dicts, whole-model gradients and, for the ROI
heads, the gradients on the same features. Cases, batch and tolerances:
``torch_rcnn_train.py``.
"""
import pytest
import torch

from torch_rcnn_train import (check_head_gradients, check_losses,
                              check_whole_model_gradients, train_run)

torch.set_num_threads(1)


@pytest.mark.parametrize("case", ["mask_keypoint", "rpn", "sem"])
def test_losses_match_jax(case):
    check_losses(train_run(case))


@pytest.mark.parametrize("case", ["mask_keypoint", "rpn", "sem"])
def test_whole_model_gradients_match_jax(case):
    check_whole_model_gradients(train_run(case))


def test_head_gradients_match_jax_on_the_same_features():
    check_head_gradients(train_run("mask_keypoint"))
