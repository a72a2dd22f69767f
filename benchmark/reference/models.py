"""Source activations of the reference.

Frozen copy of ``overiva_tpu_torch/oracle/models.py`` (commit 76c639c),
``activations`` with its two floors: the absolute ``EPS`` and the relative
``REL_EPS`` times the largest activation of the source over frames.
Departure: the power comes in already summed over bins, (frames, sources).
"""

from __future__ import annotations

import numpy as np

EPS = 1e-15
REL_EPS = 1e-3

__all__ = ["EPS", "REL_EPS", "activations"]


def activations(power: np.ndarray, n_freq: int, model: str, eps: float = EPS):
    """(r, phi = 1/r), each shaped as ``power`` (T, N), from the per-frame
    power ``sum_f |Y|^2``.

    laplace: r = 2 sqrt(power); gauss: r = power / n_freq."""
    if model == "laplace":
        r = 2.0 * np.sqrt(power)
    elif model == "gauss":
        r = power / n_freq
    else:
        raise ValueError(f"unknown source model {model!r}")
    r = np.maximum(r, eps)
    r = np.maximum(r, REL_EPS * r.max(axis=0, keepdims=True))
    return r, 1.0 / r
