"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic are named in ``BENCHMARK.json``
at the root of the checkout; see ``portbench/README.md``.
"""
import os
import sys
import time

T0 = time.perf_counter()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# caches inside the checkout, at fixed paths, before torch is imported
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# the checkout's root, not this folder, leads the import path
sys.path[0] = ROOT

if __name__ == "__main__":
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], T0))
