"""K3's share of its roofline in the traced steps: the least bytes of every
pooler backward (each level's f32 gradient written once, the cotangent read
once, from the call's shapes) at the card's HBM peak, over the device time of
the ``roi_align_ml_backward*`` kernels, in percent."""
from portbench.counts import PEAK_HBM_BYTES, roofline_share

KERNELS = "roi_align_ml_backward"


def read(record):
    if record.kind != "train" or record.trace is None or not record.k3_calls:
        return None
    seconds = record.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    return roofline_share(record.k3_bytes / PEAK_HBM_BYTES, seconds)
