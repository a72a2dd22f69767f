"""NumPy oracle projection back (minimal-distortion rescaling): the port's
copy of ``overiva_tpu/oracle/projection.py``.

Reference behavior: ``pyroomacoustics.bss.common.projection_back`` as used by
``overiva.py`` / ``ive.py`` / ``auxiva_pca.py`` (SURVEY.md §2.3.6). Fixes the
per-frequency scale ambiguity of BSS by least-squares matching each separated
channel to the reference microphone signal.
"""

from __future__ import annotations

import numpy as np

__all__ = ["projection_back", "apply_projection_back"]


def projection_back(Y: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per-(freq, src) complex scale ``z`` minimizing sum_t |ref - z * Y|^2 ...

    Following the reference convention (SURVEY.md §2.3.6):

        num[f,k]   = sum_t conj(ref[t,f]) * Y[t,f,k]
        denom[f,k] = sum_t |Y[t,f,k]|^2
        z = num / denom   (1 where denom == 0)

    and the *caller* applies ``Y *= conj(z)[None]``, which realizes the
    least-squares scale ``(sum_t ref * conj(Y)) / (sum_t |Y|^2)``.

    Y: (T, F, K) complex; ref: (T, F) complex. Returns z: (F, K) complex.
    """
    num = np.sum(np.conj(ref)[:, :, None] * Y, axis=0)
    denom = np.sum(np.abs(Y) ** 2, axis=0)
    z = np.ones_like(num)
    np.divide(num, denom, out=z, where=denom > 0.0)
    return z


def apply_projection_back(Y: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Return a projection-back-scaled copy of Y against ``ref``."""
    z = projection_back(Y, ref)
    return Y * np.conj(z)[None, :, :]
