"""Utilities of the port (counterpart of ``u2seg_tpu/utils``): registry,
serialization, paths, logging, environment, OOM retry, tracing guards,
trackers, the OpenCV-free visualizer and model analysis."""
