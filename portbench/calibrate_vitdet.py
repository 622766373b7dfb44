"""Readings that the limits of the ViTDet cell are set from, in one process:

    python3 portbench/calibrate_vitdet.py --seeds 11 12 13 [--control-seeds 3] \\
        [--workload vitdet-l-train] [--out calibrate.json]

For each seed, a short run of the cell (its set-up, the compared steps and
one window step) gives the program's numbers against the reference (the
lower readings). On the first ``--control-seeds`` seeds it also reads, on
the same batches, draws and proposals, the control
(``refvitdet.replay.control_replay``: fp8 operands and gradients) and each
fault of ``refvitdet.replay.FAULTS`` planted in the reference at the
configuration's own precision, each against the f32 reference and against
the reference at the configuration's dtype (``*_bf16``). A state left
unchanged reads 1 by construction and needs no run. ``calibrate_train.py``
does the same for the cells of ``drivers/train.py``, whose reference this
cell does not use.

Not part of a benchmark run: run it on the card to set the limits of
``portbench/workloads/vitdet-l-train.json``.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None) -> int:
    from portbench import harness, reference_train as rt
    from portbench.refvitdet import replay

    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="vitdet-l-train")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    rows = []
    for i, seed in enumerate(a.seeds):
        t0 = time.perf_counter()
        args = harness.parse_args(["--workload", a.workload, "--seed", str(seed),
                                   "--seconds", "0", "--trace", "0"])
        rec, _ = harness.run_cell(args, t0, device=a.device)
        x = rec.extra
        row = {"seed": seed, "correct": rec.correct, "program": x["numbers"],
               "losses": [[p["total_loss"], r["total_loss"]] for p, r in
                          zip(x["program"].losses, x["reference"].losses)]}
        if i < a.control_seeds:
            kw = dict(proposals=x["proposals"], state=x["state"])
            own = rt.own_precision(x["ref_cfg"], x["compute_dtype"])
            sides = {"control": lambda: replay.control_replay(
                x["ref_cfg"], x["seed"], x["tau"], x["kept"], a.device, **kw)}
            for fault in replay.FAULTS:
                sides[fault] = (lambda f=fault: replay.replay(
                    own, x["seed"], x["tau"], x["kept"], a.device, fault=f, **kw))
            for name, side in sides.items():
                got = side()
                row[name] = replay.compare_both(got, x["reference"], x["reference16"],
                                                x["global_blocks"])
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


if __name__ == "__main__":
    sys.exit(main())
