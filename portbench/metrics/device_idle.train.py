"""The share of a training step, in percent, in which no kernel ran on the
card: 1 minus the union of kernel intervals in the traced steps, per step,
over the time an untraced step of the same window takes (the profiler's
host cost stretches the traced steps, not the device's work)."""


def read(record):
    if (record.kind != "train" or record.trace is None or not record.traced_steps
            or not record.untraced_steps or record.untraced_s <= 0):
        return None
    busy = record.trace.busy_s / record.traced_steps
    return 100.0 * (1.0 - busy / (record.untraced_s / record.untraced_steps))
