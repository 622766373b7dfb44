"""Part of the u2seg_torch port; see the package docstring."""
from u2seg_torch.models.build import META_ARCH_REGISTRY, build_model, register_meta_arch

__all__ = ["META_ARCH_REGISTRY", "build_model", "register_meta_arch"]
