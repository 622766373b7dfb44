"""Host ms per training step in the program's ``u2s.forward`` span (training
mode, zero_grad, the model's losses and their sum), over the traced whole
steps; the profiler stretches them."""
from portbench import spantrace


def read(record):
    return spantrace.host_ms_per_step(record, ["u2s.forward"])
