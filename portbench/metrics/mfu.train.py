"""The training steps' FLOPs (forward and backward, counted on the
benchmark's reference model at each step's bucket) over the steps' time and
the card's dense peak in the configuration's compute dtype (bf16; tf32 for
an f32 configuration, whose convolutions cuDNN runs in tf32), in percent.
Taken over the untraced steps of a traced run's window: the profiler's host
cost stretches the traced ones."""
from portbench.counts import PEAK_FLOPS


def read(record):
    if record.kind != "train" or not record.untraced_flops or record.untraced_s <= 0:
        return None
    peak = PEAK_FLOPS[record.compute_dtype]
    return 100.0 * record.untraced_flops / (record.untraced_s * peak)
