"""NumPy oracle AuxIVA-ISS (iterative source steering): the port's copy of
``overiva_tpu/oracle/auxiva_iss.py``.

Capability extension beyond the reference repo (which is IP-only), from the
retrieved literature (PAPERS.md: arXiv:2009.09402 "Accelerating
auxiliary-function-based IVA" / Scheibler & Ono 2020, "Fast and stable blind
source separation with rank-1 updates"): the auxiliary function is minimized
by a sequence of rank-1 "source steering" updates

    Y <- Y - d_n (x) Y[n],   W <- W - d_n (x) W[n]

with closed-form per-frequency coefficients — no matrix solves at all, which
makes it the TPU-friendliest member of the family. Determined (N == M).
"""

from __future__ import annotations

import numpy as np

from .models import activations
from .projection import apply_projection_back, projection_back

__all__ = ["auxiva_iss"]

_EPS = 1e-15


def auxiva_iss(
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
    """X: (n_frames, n_freq, n_chan) complex; returns Y [, W]."""
    X = np.asarray(X)
    T, F, M = X.shape
    N = M if n_src is None else n_src
    if N != M:
        raise ValueError("auxiva_iss is determined: n_src must equal n_chan")

    W = np.tile(np.eye(M, dtype=X.dtype), (F, 1, 1)) if W0 is None else W0.copy()
    Y = np.einsum("fnm,tfm->tfn", W, X)

    for epoch in range(n_iter):
        if callback is not None and epoch % callback_every == 0:
            callback(apply_projection_back(Y, X[:, :, 0]))

        r, phi = activations(Y, model)  # (T, N)

        for n in range(N):
            yn = Y[:, :, n]  # (T, F)
            # v_m[f] = E[phi_m y_m conj(y_n)] / E[phi_m |y_n|^2],  m != n
            num = np.einsum("tm,tfm,tf->fm", phi, Y, np.conj(yn))
            den = np.einsum("tm,tf->fm", phi, np.abs(yn) ** 2)
            v = num / np.maximum(den, _EPS)  # (F, M)
            # v_n[f] = 1 - 1/sqrt((1/T) E[phi_n |y_n|^2])
            dnn = den[:, n] / T
            v[:, n] = 1.0 - 1.0 / np.sqrt(np.maximum(dnn, _EPS))
            Y = Y - v[None, :, :] * yn[:, :, None]
            W = W - v[:, :, None] * W[:, n, :][:, None, :]

    if proj_back:
        z = projection_back(Y, X[:, :, 0])
        Y = Y * np.conj(z)[None, :, :]
    if return_filters:
        return Y, W
    return Y
