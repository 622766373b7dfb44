"""Data parallelism over ``torch.distributed`` (counterpart of ``u2seg_tpu/parallel``)."""
