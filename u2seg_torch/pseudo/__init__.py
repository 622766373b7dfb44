"""The pseudo-label pipeline: DINO crop features, kNN and k-means, USL
selection, USL-T heads and the panoptic pseudo-annotation assembly."""
