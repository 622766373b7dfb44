"""Part of the u2seg_torch port; see the package docstring."""
