"""Separation-quality metrics: the port's copy of ``bss_eval_sources``."""

from .bss_eval import BssEvalReferences, bss_eval_sources

__all__ = ["BssEvalReferences", "bss_eval_sources"]
