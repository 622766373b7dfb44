"""Syncs per training step: the CUDA runtime calls inside the traced whole
steps (``u2s.step`` spans) after which the host waits for the card
(stream, device and event synchronizations, synchronous copies): each NMS
round's check, the losses' readback, every other ``.item()``, ``.tolist()``
or ``torch.equal`` on the card, and copies from pageable memory."""
from portbench import spantrace


def read(record):
    return spantrace.syncs_per_step(record)
