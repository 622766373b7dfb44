"""Training and inference engine of the port (counterpart of ``u2seg_tpu/engine``)."""
