"""Kernels the card ran per training step in the traced steps (device trace;
copies and fills not counted)."""


def read(record):
    if record.kind != "train" or record.trace is None or not record.traced_steps:
        return None
    return len(record.trace.kernels) / record.traced_steps
