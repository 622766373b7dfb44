"""The training forward of u2seg_torch's Cascade Mask R-CNN vs the JAX
package on the CPU: the loss dict (3 box stages, RPN, mask), whole-model
gradients and the heads' gradients on the same features. Cases, batch and
tolerances: ``torch_rcnn_train.py``.
"""
import torch

from torch_rcnn_train import (check_head_gradients, check_losses,
                              check_whole_model_gradients, train_run)

torch.set_num_threads(1)


def test_losses_match_jax():
    check_losses(train_run("cascade_mask"))


def test_whole_model_gradients_match_jax():
    check_whole_model_gradients(train_run("cascade_mask"))


def test_head_gradients_match_jax_on_the_same_features():
    check_head_gradients(train_run("cascade_mask"))
