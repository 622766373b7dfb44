"""One traced run of a training cell, read through the program's own spans.

    python3 portbench/trace_program.py --workload u2seg800-train --seed 12345 \
        --seconds 50 [--spans 0] [--out runs/trace_program.jsonl]

It runs the cell as ``portbench/run.py --trace 1`` does, with the traced
window reduced by ``spantrace.extend`` (the program's ``u2s.*`` spans, the
host's syncs, each kernel's launch), and reads ``PROGRAM_METRICS`` beside
the cell's own per-layer metrics. It prints the result line with a
``program`` section: per whole step, host ms by span, idle ms by the span
that each gap began in and by the span open at each instant of it, kernel
ms by the span that launched them, syncs by span, ``u2s.gc`` time and count,
the share of each step no span covers, and the lags of syncs behind the
work they waited for (one clock for host and card). With ``--spans 0`` the
program opens no span (the same run, for the spans' cost when traced).
Needs a CUDA card, as ``run.py`` does.
"""
import argparse
import json
import os
import statistics
import sys
import time

T0 = time.perf_counter()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[0] = ROOT

TRAIN_CELLS = ["u2seg800-train", "pfpn3x-train"]
# the per-layer metrics of the program's spans, as BENCHMARK.json would list them
PROGRAM_METRICS = [
    {"name": "host_syncs_per_step.train", "unit": "count", "better": "lower",
     "source": "device_trace", "layer": "train step", "moves": "train_images_per_s",
     "workloads": TRAIN_CELLS},
    {"name": "forward_host_ms.train", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "model step", "moves": "train_images_per_s",
     "workloads": TRAIN_CELLS},
    {"name": "backward_host_ms.train", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "model step", "moves": "train_images_per_s",
     "workloads": TRAIN_CELLS},
    {"name": "optimizer_host_ms.train", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "train step", "moves": "train_images_per_s",
     "workloads": TRAIN_CELLS},
    {"name": "step_overhead_ms.train", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "training loop", "moves": "train_images_per_s",
     "workloads": TRAIN_CELLS},
]
# the labels of gaps that no stage of the program names
UNNAMED = ("host", "pb.run_step", "pb.train_step")


def per_step_ms(values: dict, steps: int) -> dict:
    return {k: v * 1e-6 / steps for k, v in sorted(values.items(), key=lambda kv: -kv[1])}


def summarize(record) -> dict:
    """What the program's spans say of the traced window (see the module
    docstring); every time in ms per step."""
    from portbench import spantrace

    tr = record.trace
    steps = tr.steps()
    n_whole, n_traced = len(steps), record.traced_steps
    step_ns = sum(e - s for s, e in steps)
    idle = tr.idle_by_span()
    idle_ns = sum(idle.values())
    named = sum(v for k, v in idle.items() if k.startswith(spantrace.SPAN_PREFIX)
                and k != spantrace.STEP)
    lo = tr.window[0]
    gaps = sorted(tr.gaps(), key=lambda g: g[0] - g[1])
    label = tr.labeller()
    top = [[label(s), (e - s) * 1e-6] for s, e in gaps if s != lo][:10]
    gc = [(e - s) for name, s, e in tr.in_steps(tr.spans) if name == "u2s.gc"]
    lags = tr.sync_lags()
    return {
        "whole_steps": n_whole, "traced_steps": n_traced,
        "step_ms": step_ns * 1e-6 / max(n_whole, 1),
        "traced_ms": tr.window_s * 1e3 / n_traced,
        "untraced_ms": (1e3 * record.untraced_s / record.untraced_steps
                        if record.untraced_steps else None),
        "images_per_s": record.images / record.window_s,
        "spans_per_step": len(tr.in_steps(tr.spans)) / max(n_whole, 1),
        "uncovered_share": tr.uncovered_ns() / step_ns if step_ns else None,
        "idle_ms": idle_ns * 1e-6 / n_traced,
        "idle_named_share": named / idle_ns if idle_ns else None,
        "top_gaps_ms": top,
        "top_gaps_unnamed": sum(1 for name, _ in top if name in UNNAMED),
        "host_ms": per_step_ms(tr.host_ns_by_span(), max(n_whole, 1)),
        "idle_by_span_ms": per_step_ms(idle, n_traced),
        "idle_over_spans_ms": per_step_ms(tr.idle_over_spans(), n_traced),
        "device_ms": per_step_ms(tr.device_ns_by_span(), n_traced),
        "syncs": {k: v / n_traced for k, v in sorted(tr.syncs_by_span().items(),
                                                      key=lambda kv: -kv[1])},
        "gc_per_step": len(gc) / max(n_whole, 1),
        "gc_ms": sum(gc) * 1e-6 / max(n_whole, 1),
        "sync_lag_us": ({"n": len(lags), "min": min(lags) * 1e-3,
                         "median": statistics.median(lags) * 1e-3,
                         "max": max(lags) * 1e-3,
                         "share_0_100": sum(0 <= x <= 100_000 for x in lags) / len(lags)}
                        if lags else None),
    }


def main(argv) -> int:
    p = argparse.ArgumentParser(description="a traced run read through the program's spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    p.add_argument("--out", default=None, help="a JSON-lines file the line is appended to")
    args = p.parse_args(argv)

    from portbench import devtrace, harness, spantrace

    reduce = devtrace.Profiler._reduce
    devtrace.Profiler._reduce = lambda self: spantrace.extend(
        reduce(self), self._prof.profiler.kineto_results.events())
    if not args.spans:
        from u2seg_torch.utils import spans
        spans._enabled = lambda: False
    bench = harness.load_benchmark()
    known = {m["name"] for m in bench["per_layer"]}
    bench["per_layer"] += [m for m in PROGRAM_METRICS if m["name"] not in known]
    cell = harness.find_cell(bench, args.workload)
    device = harness.check_device(cell["chips"])
    run_args = argparse.Namespace(workload=args.workload, seed=args.seed,
                                  seconds=args.seconds, trace=1)
    record, metrics = harness.run_cell(run_args, T0, bench=bench)
    device["busy_s"], device["window_s"] = record.busy_s, record.traced_s
    line = harness.result_line(record, metrics, device, True)
    line.update(workload=args.workload, seed=args.seed, spans=args.spans,
                program=summarize(record))
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
