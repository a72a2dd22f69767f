"""NumPy oracle source models: the port's copy of the parts of
``overiva_tpu/oracle/models.py`` that the float64 OverIVA oracle needs.

Reference behavior: ``overiva.py`` / ``pyroomacoustics.bss.auxiva`` source
models (SURVEY.md §2.3.1). Both the time-invariant spherical Laplace prior and
the time-varying Gaussian prior share the same iterative-projection update;
only the per-frame weight ``phi = 1/r`` differs.
"""

from __future__ import annotations

import numpy as np

EPS = 1e-15  # activation floor (SURVEY.md §2.3, VERIFY-flagged exact value)
# Relative floor bounding the weight dynamic range (deliberate stability
# deviation from the reference's absolute-only floor; PARITY.md row 13):
# prevents the gauss-model collapse at M >> N where an output nulls a frame
# and phi = 1/r blows the weighted covariance up to singularity (NaN in
# float64 as well).
REL_EPS = 1e-3

__all__ = ["EPS", "REL_EPS", "activations", "align_eigvec_phase"]


def align_eigvec_phase(E: np.ndarray) -> np.ndarray:
    """Deterministic eigenvector phase: largest-|.| component real-positive.

    E: (F, M, K) columns are eigenvectors. eigh only defines eigenvectors up
    to a per-vector phase, and LAPACK and other backends choose different
    ones; fixing the convention keeps optimization trajectories comparable
    (PARITY.md, round-2 PCA fix).
    """
    idx = np.argmax(np.abs(E), axis=1)  # (F, K)
    anchor = np.take_along_axis(E, idx[:, None, :], axis=1)[:, 0, :]
    phase = anchor / np.maximum(np.abs(anchor), 1e-30)
    return E * np.conj(phase)[:, None, :]


def activations(Y: np.ndarray, model: str, eps: float = EPS):
    """Per-frame source activations ``r`` and weights ``phi = 1/r``.

    Y: (n_frames, n_freq, n_src) complex STFT of current source estimates.
    Returns (r, phi), each (n_frames, n_src) real.

    laplace: r[t,k] = 2 * sqrt( sum_f |Y[t,f,k]|^2 )
    gauss:   r[t,k] = ( sum_f |Y[t,f,k]|^2 ) / n_freq
    """
    power = np.sum(np.abs(Y) ** 2, axis=1)  # (T, N)
    if model == "laplace":
        r = 2.0 * np.sqrt(power)
    elif model == "gauss":
        r = power / Y.shape[1]
    else:
        raise ValueError(f"unknown source model {model!r}")
    r = np.maximum(r, eps)
    r = np.maximum(r, REL_EPS * r.max(axis=0, keepdims=True))
    return r, 1.0 / r
