"""Host ms per training step around the model's step: the batch's upload
(``u2s.upload``), the losses' readback and storage (``u2s.metrics``) and
the program's hooks (``u2s.hook.*``; the benchmark's own window hook left
out), over the traced whole steps; the profiler stretches them."""
from portbench import spantrace


def read(record):
    return spantrace.host_ms_per_step(record, ["u2s.upload", "u2s.metrics", "u2s.hook."])
