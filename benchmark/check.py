"""The comparisons that decide ``correct``."""

from __future__ import annotations

import numpy as np

__all__ = ["rel_err", "rel_err_cols", "worst"]


def rel_err(a, b) -> float:
    """||a - b|| / ||b|| over the whole array (NaN if ``b`` is zero)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return float("nan")
    nb = float(np.linalg.norm(b))
    return float(np.linalg.norm(a - b)) / nb if nb > 0 else float("nan")


def rel_err_cols(a, b) -> float:
    """The largest of :func:`rel_err` over the columns (separated sources)
    of two (n_samples, n_out) arrays."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return float("nan")
    return worst(rel_err(a[:, k], b[:, k]) for k in range(b.shape[1]))


def worst(values) -> float:
    """The largest value, NaN if any is NaN or there is none: a reading
    that gives no number fails its limit."""
    values = list(values)
    if not values or any(np.isnan(v) for v in values):
        return float("nan")
    return max(values)
