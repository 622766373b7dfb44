"""Set-up time: process start to the first timed unit (import, CUDA context,
seeded model, kernels from cache, data files, the compared steps, warm-up)."""


def read(record):
    return record.setup_s
