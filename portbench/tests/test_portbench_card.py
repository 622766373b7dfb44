"""The training cells' control and faults on the card, at the cells' own
size: the control (the reference put in the program's place one precision
below the configuration's), each fault of ``reference_train.FAULTS`` planted
in the reference at the configuration's precision (half of the batch left
out, the learning rate doubled, the update's sign flipped, and, where the
configuration does not clip them, the gradients doubled) and a state left
unchanged must each come out not correct. Marked ``cuda``; skipped where
there is no card.

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda portbench/tests
"""
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness, reference_train  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _fails(numbers, limits) -> list:
    """The limited numbers that ``numbers`` fail."""
    return [k for k, v in limits.items() if k in numbers and numbers[k] > v]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["u2seg800-train", "pfpn3x-train"])
def test_faults_and_control_are_not_correct(card, cell):
    args = harness.parse_args(["--workload", cell, "--seed", "3141592653",
                               "--seconds", "0", "--trace", "0"])
    rec, _ = harness.run_cell(args, time.perf_counter())
    assert rec.correct, rec.checks
    x = rec.extra
    limits = harness.load_traffic(cell)["limits"]
    kw = dict(proposals=x["proposals"], frozen_norms_from=x["frozen_norms_from"])

    def numbers(got):
        return reference_train.compare_both(got, x["reference"], x["reference16"])

    unchanged = reference_train.Readings(losses=x["program"].losses,
                                         init_norms=x["program"].init_norms,
                                         rpn_heads=x["program"].rpn_heads)
    assert _fails(numbers(unchanged), limits)
    control = reference_train.control_replay(x["ref_cfg"], x["compute_dtype"], x["seed"],
                                             x["tau"], x["kept"], "cuda", **kw)
    assert _fails(numbers(control), limits), "control"
    faults = ["half_batch", "lr_x2", "negated_update"]
    if not x["ref_cfg"].solver.clip_gradients:
        faults.append("grad_x2")
    own = reference_train.own_precision(x["ref_cfg"], x["compute_dtype"])
    for fault in faults:
        got = reference_train.replay(own, x["seed"], x["tau"], x["kept"], "cuda",
                                     fault=fault, **kw)
        assert _fails(numbers(got), limits), fault
