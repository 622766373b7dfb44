"""The ViT attention block's share of the card's dense peak in the traced
steps, in percent: its FLOPs (``counts_vitdet.attention_flops``: qkv, the
relative-position terms, the score product, the product with v and proj,
forward and backward, from shapes) over the device time of
``attn_ms.train``, the same block in both directions, and the peak of the
configuration's compute dtype (``counts.PEAK_FLOPS``)."""
from portbench.counts import PEAK_FLOPS
from portbench.harness import load_reader


def read(record):
    flops = getattr(record, "attn_flops", 0.0)
    if not flops:
        return None
    ms = load_reader("attn_ms.train")(record)
    if not ms:
        return None
    return 100.0 * flops / (ms * 1e-3 * PEAK_FLOPS[record.compute_dtype])
