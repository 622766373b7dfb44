"""Host time per step that the training loop waits for its next batch, over
the window (the benchmark's timed wrapper around the loader)."""


def read(record):
    if record.kind != "train" or not record.data_wait_s:
        return None
    return 1e3 * sum(record.data_wait_s) / len(record.data_wait_s)
