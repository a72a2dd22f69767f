"""Separation-quality metrics: the port's copy of ``bss_eval_sources`` and
``bss_eval_images``."""

from .bss_eval import BssEvalReferences, bss_eval_images, bss_eval_sources

__all__ = ["BssEvalReferences", "bss_eval_images", "bss_eval_sources"]
