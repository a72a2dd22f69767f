"""NumPy oracle OverIVA-ISS (overdetermined iterative source steering): the
port's copy of ``overiva_tpu/oracle/overiva_iss.py``, the float64 reference
that ``chip_smoke.py`` holds the port to.

Extension beyond the reference repo (which is IP-only for the overdetermined
case, reference ``overiva.py`` per SURVEY.md §2.3.3): rank-1 source-steering
updates for N < M, derived from the unified overdetermined-IVA view of the
retrieved literature (PAPERS.md: arXiv:2003.02458 "Overdetermined independent
vector analysis", Ikeshita et al.; arXiv:2009.09402):

    Overdetermined IVA over M channels == determined IVA where the first N
    outputs carry the source-model weights phi_k(t) and the remaining M - N
    "background" outputs carry a stationary unit-Gaussian model, i.e.
    time-invariant weights phi_i(t) = 1 (their weighted covariance is Cx).

Under that view the determined ISS updates (rank-1 steering, no solves —
``oracle/auxiva_iss.py``) apply verbatim with the concatenated weights. The
background self-update normalizes each background output to unit per-bin
power, whose stationary condition is the orthogonal-constraint solution the
IP variant imposes explicitly (same MM objective, same fixed points; the
trajectory differs, so OverIVA-ISS is parity-tested against THIS oracle, not
against OverIVA-IP). N == M degenerates exactly to ``auxiva_iss``.
"""

from __future__ import annotations

import numpy as np

from .models import activations
from .projection import apply_projection_back, projection_back

__all__ = ["overiva_iss"]

_EPS = 1e-15


def overiva_iss(
    X: np.ndarray,
    n_src: int | None = None,
    n_iter: int = 20,
    proj_back: bool = True,
    W0: np.ndarray | None = None,
    model: str = "laplace",
    return_filters: bool = False,
    callback=None,
    callback_every: int = 10,
):
    """X: (n_frames, n_freq, n_chan) complex; returns Y (T, F, n_src) [, W].

    W0 may be the full (F, M, M) demixing stack or (F, N, M) target rows
    (placed into identity background rows), mirroring ``oracle/overiva``.
    """
    X = np.asarray(X)
    T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if not 1 <= N <= M:
        raise ValueError(f"n_src must be in [1, {M}], got {N}")

    W = np.tile(np.eye(M, dtype=X.dtype), (F, 1, 1))
    if W0 is not None:
        if W0.shape[1] == M:
            W = W0.copy()
        else:
            W[:, :N, :] = W0
    Y = np.einsum("fnm,tfm->tfn", W, X)

    for epoch in range(n_iter):
        if callback is not None and epoch % callback_every == 0:
            callback(apply_projection_back(Y[:, :, :N], X[:, :, 0]))

        # model weights for the N targets; unit Gaussian (phi = 1) background
        r, phi = activations(Y[:, :, :N], model)  # (T, N)
        if N < M:
            phi = np.concatenate([phi, np.ones((T, M - N), phi.dtype)], axis=1)

        for n in range(M):
            yn = Y[:, :, n]  # (T, F)
            num = np.einsum("tm,tfm,tf->fm", phi, Y, np.conj(yn))
            den = np.einsum("tm,tf->fm", phi, np.abs(yn) ** 2)
            v = num / np.maximum(den, _EPS)  # (F, M)
            dnn = den[:, n] / T
            v[:, n] = 1.0 - 1.0 / np.sqrt(np.maximum(dnn, _EPS))
            Y = Y - v[None, :, :] * yn[:, :, None]
            W = W - v[:, :, None] * W[:, n, :][:, None, :]

    Y = Y[:, :, :N]
    if proj_back:
        z = projection_back(Y, X[:, :, 0])
        Y = Y * np.conj(z)[None, :, :]
    if return_filters:
        return Y, W
    return Y
