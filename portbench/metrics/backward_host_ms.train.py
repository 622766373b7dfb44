"""Host ms per training step in the program's ``u2s.backward`` span (the
backward pass; the all-reduce over processes where there are several), over
the traced whole steps; the profiler stretches them."""
from portbench import spantrace


def read(record):
    return spantrace.host_ms_per_step(record, ["u2s.backward"])
