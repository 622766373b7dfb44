"""The benchmark's run of one cell: find the cell, its configuration and its
traffic by name, check the device, hand them to the traffic's driver, read
every metric of the cell from the run's record, check that nothing of JAX was
loaded, and print the result line.

Everything is found by name, so a later cell or metric is a new file:
- ``BENCHMARK.json`` names the cell's configuration, traffic and metrics;
- ``portbench/configs/<config>.yaml``: the configuration as it is run;
- ``portbench/workloads/<traffic>.json``: the traffic's parameters, its
  ``driver`` (a module ``portbench/drivers/<driver>.py``) and the limits of
  the numbers that decide ``correct``;
- ``portbench/metrics/<metric>.py``: a ``read(record)`` that returns the
  metric's value from a run's record, or None where it finds nothing.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# top-level module names a run may not load (compared whole: the port's
# name begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "u2seg_tpu")


class RunFailed(Exception):
    """The run cannot give a result (no device, a bad name, a fault)."""


def forbidden_modules(names) -> List[str]:
    """The names among ``names`` whose top-level part is forbidden."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN_MODULES})


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise RunFailed(f"no workload {name!r} in BENCHMARK.json")


def find_config(bench: dict, name: str) -> dict:
    for cfg in bench["configs"]:
        if cfg["name"] == name:
            return cfg
    raise RunFailed(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(name: str) -> dict:
    path = os.path.join(HERE, "workloads", name + ".json")
    if not os.path.exists(path):
        raise RunFailed(f"no traffic file {path}")
    with open(path) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``trace`` 0, its per-layer metrics with ``trace`` 1."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def load_reader(name: str):
    """``portbench/metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.exists(path):
        raise RunFailed(f"no reader {path} for metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def check_device(chips: int) -> Dict[str, object]:
    """The cards of this run; raises where there are fewer than ``chips``."""
    import torch

    if not torch.cuda.is_available():
        raise RunFailed("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise RunFailed(f"the cell asks for {chips} cards, "
                        f"{torch.cuda.device_count()} are visible")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def read_metrics(metrics: List[dict], record) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = load_reader(m["name"])(record)
        if value is None:
            continue
        if not math.isfinite(value):
            raise RunFailed(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(record, metrics: Dict[str, dict], device: dict, trace: bool) -> dict:
    line = {"correct": record.correct, "attempted": record.attempted,
            "failed": record.failed, "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = record.breakdown
    line["checks"] = record.checks
    return line


def parse_args(argv):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Context:
    """What a driver is handed: the run's arguments, the cell, the
    configuration file, the traffic, the device and a scratch folder."""

    def __init__(self, args, cell: dict, config_file: str, traffic: dict,
                 device: str, scratch: str, t0: float):
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.cell, self.config_file, self.traffic = cell, config_file, traffic
        self.device, self.scratch, self.t0 = device, scratch, t0


def run_cell(args, t0: float, device: Optional[str] = None, config_file: Optional[str] = None,
             traffic: Optional[dict] = None, bench: Optional[dict] = None):
    """Drive one run and return (record, metrics). ``device``,
    ``config_file``, ``traffic`` and ``bench`` replace what the checkout
    holds (the CPU tests drive a tiny cell so); by default the cell runs on
    the card it asks for."""
    bench = bench or load_benchmark()
    cell = find_cell(bench, args.workload)
    cfg_entry = find_config(bench, cell["config"])
    config_file = config_file or os.path.join(ROOT, cfg_entry["file"])
    traffic = traffic or load_traffic(cell["traffic"])
    scratch = tempfile.mkdtemp(prefix="portbench-")
    try:
        ctx = Context(args, cell, config_file, traffic, device or "cuda", scratch, t0)
        record = load_driver(traffic["driver"]).run(ctx)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return record, read_metrics(cell_metrics(bench, cell["name"], bool(args.trace)), record)


def main(argv, t0: float) -> int:
    args = parse_args(argv)
    try:
        bench = load_benchmark()
        cell = find_cell(bench, args.workload)
        device = check_device(cell["chips"])
        record, metrics = run_cell(args, t0, bench=bench)
        found = forbidden_modules(sys.modules)
        if found:
            raise RunFailed(f"modules of JAX or the JAX package were loaded: {found}")
    except RunFailed as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 2
    device["memory_peak_bytes"] = record.memory_peak_bytes
    if args.trace:
        device["busy_s"], device["window_s"] = record.busy_s, record.traced_s
    for name, c in record.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {record.correct}", file=sys.stderr, flush=True)
    print(json.dumps(result_line(record, metrics, device, bool(args.trace))), flush=True)
    return 0
