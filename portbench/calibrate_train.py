"""Readings that the limits of a training cell are set from, in one process:

    python3 portbench/calibrate_train.py --workload u2seg800-train --seeds 11 12 13 \\
        [--control-seeds 3] [--out calibrate.json]

For each seed, a short run of the cell (its set-up, the compared steps and
one window step) gives the program's numbers against the reference (the
lower readings). On the first ``--control-seeds`` seeds it also reads, on
the same batches, the control (``reference_train.control_replay``) and each
fault of ``reference_train.FAULTS`` planted in the reference at the
configuration's own precision, each against the f32 reference and against
the reference at the configuration's dtype (``*_bf16``). A state left
unchanged reads 1 by construction and needs no run. With ``--leaves`` each
row also holds every side's per-leaf norms (first gradient, change after
the steps) and angles to the reference at the configuration's dtype, so
that other forms of the leaf numbers can be read from one run.

Not part of a benchmark run: run it on the card to set the limits of
``portbench/workloads/<traffic>.json``.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None) -> int:
    from portbench import harness, reference_train

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out", default="")
    p.add_argument("--leaves", action="store_true")
    a = p.parse_args(argv)
    rows = []
    for i, seed in enumerate(a.seeds):
        t0 = time.perf_counter()
        args = harness.parse_args(["--workload", a.workload, "--seed", str(seed),
                                   "--seconds", "0", "--trace", "0"])
        rec, _ = harness.run_cell(args, t0)
        x = rec.extra
        moved = [tuple(t.clone() for t in p) for p in x["proposals"]]
        moved[0][0][0, 0] += 1.0            # one proposal of step 1 a pixel off
        row = {"seed": seed, "program": x["numbers"],
               "proposal_fault": reference_train.proposal_gap(moved[0], x["proposals"][0]),
               "program_losses": [[p["total_loss"], r["total_loss"]] for p, r in
                                  zip(x["program"].losses, x["reference"].losses)],
               "worst": reference_train.worst_leaves(x["program"], x["reference"]),
               "worst_update": reference_train.worst_leaves(x["program"], x["reference"],
                                                            key="update_norms")}
        if a.leaves:
            row["leaves"] = {"program": leaf_table(x["program"], x["reference16"]),
                             "reference": leaf_table(x["reference"], x["reference16"]),
                             "reference16": leaf_table(x["reference16"], x["reference16"])}
        if i < a.control_seeds:
            kw = dict(proposals=x["proposals"], frozen_norms_from=x["frozen_norms_from"])
            own = reference_train.own_precision(x["ref_cfg"], x["compute_dtype"])
            sides = {"control": lambda: reference_train.control_replay(
                x["ref_cfg"], x["compute_dtype"], x["seed"], x["tau"], x["kept"], "cuda", **kw)}
            for fault in reference_train.FAULTS:
                sides[fault] = (lambda f=fault: reference_train.replay(
                    own, x["seed"], x["tau"], x["kept"], "cuda", fault=f, **kw))
            for name, side in sides.items():
                got = side()
                row[name] = reference_train.compare_both(got, x["reference"],
                                                         x["reference16"])
                if a.leaves:
                    row["leaves"][name] = leaf_table(got, x["reference16"])
                del got
        row["seconds"] = time.perf_counter() - t0
        del rec, x
        rows.append(row)
        print(json.dumps(row), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


def leaf_table(side, ref) -> dict:
    """Per leaf of ``ref``: the side's norms and its angles to ``ref``."""
    from portbench import reference_train

    names = sorted(ref.grad_norms)
    moved = [n for n in names if n in ref.updates]
    return {"grad_norm": {n: side.grad_norms.get(n, 0.0) for n in names},
            "update_norm": {n: side.update_norms.get(n, 0.0) for n in moved},
            "grad_angle": dict(zip(names, reference_train.angle_gaps(side.grads, ref.grads,
                                                                     names))),
            "update_angle": dict(zip(moved, reference_train.angle_gaps(
                side.updates, ref.updates, moved))),
            "bias_grads": {n: side.grads[n].tolist() for n in names
                           if n.endswith("bbox_pred.bias") and n in side.grads}}


if __name__ == "__main__":
    sys.exit(main())
